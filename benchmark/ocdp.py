"""The port's own span names (``ocdp.*``, recorded by
``ocdp_tpu_torch.profiling.span`` while a profiler runs), as ``SPANS``
targets a metric can declare.

The profile pass collects the host events whose names its metrics' ``SPANS``
give (``tracing.span_name``: the module's last part, a dot, the attribute).
This module's last part is ``ocdp`` and its attributes are the rest of each
name, so ``"benchmark.ocdp:engine.check"`` collects the port's
``ocdp.engine.check`` spans: ``Trace.in_span`` then counts the runtime
calls inside them, and ``Trace.idle`` charges a device-idle gap to the
innermost of them open at the gap's start. The attributes are wrapped and
put back like any target; nothing calls them. Against a port that records
no such span, nothing is collected.
"""

NAMES = ("ocdp.solve", "ocdp.build", "ocdp.rowlane.analyse",
         "ocdp.backup6d.analyse", "ocdp.backup6d.read", "ocdp.engine.prepare",
         "ocdp.engine.capture", "ocdp.engine.sweeps", "ocdp.engine.check",
         "ocdp.engine.finish")
SOLVE = "ocdp.solve"
PREFIX = "ocdp."
# every name, so that the port's spans are told apart from the time under
# none of them wherever a metric looks
TARGETS = tuple(f"benchmark.ocdp:{n[len(PREFIX):]}" for n in NAMES)


def _name_only(*args, **kwargs):
    raise RuntimeError("benchmark.ocdp's attributes name spans; nothing "
                       "calls them")


for _attr in (t.split(":")[1] for t in TARGETS):
    globals()[_attr] = _name_only


def recorded(t) -> bool:
    """Whether the profile ``t`` holds the port's spans: the runtime calls
    of every solve are made inside ``ocdp.solve``."""
    return any(span == SOLVE for span, _ in t.in_span)
