"""The benchmark of ``ocdp_tpu_torch`` on one H100: ``python3 benchmark/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` (see ``run.py``)."""
