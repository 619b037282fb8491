"""The yardstick of the kernels' rooflines: the H100's peaks, and the FP32
operations and bytes of one sweep of each backup kernel, counted from the
interpolation taps that the benchmark derives itself from the
configuration (``benchmark/reference``), never from the port's objects."""
