"""Analysis layer: the cost model (a counter over the torch dispatcher in
the JAX package's HLO parser's role, and the H100's roofline), the
protocol sanitizer and the repo lint.

Re-exports are lazy: ``cost``/``roofline`` pull in torch, but the
``sanitize`` instrumentation hooks live on hot control-plane paths and
the ``lint`` CLI must start fast — importing this package must stay
cheap (stdlib only) so ``from repro_torch.analysis import sanitize``
inside ``repro_torch.core`` neither costs a torch import nor creates a
cycle.
"""
from __future__ import annotations

_COST = ("Cost", "analyze_call")
_ROOFLINE = ("RooflineTerms", "count_params", "model_flops", "roofline",
             "PEAK_FLOPS", "PEAK_FLOPS_TF32", "PEAK_FLOPS_F32", "HBM_BW",
             "LINK_BW")

__all__ = [*_COST, *_ROOFLINE, "cost", "roofline", "sanitize", "lint"]


def __getattr__(name: str):
    import importlib
    if name in ("cost", "sanitize", "lint"):
        return importlib.import_module(f"repro_torch.analysis.{name}")
    if name in _COST or name in _ROOFLINE:
        sub = "cost" if name in _COST else "roofline"
        mod = importlib.import_module(f"repro_torch.analysis.{sub}")
        # pin the resolved attribute, and roofline() with it: the submodule
        # import just rebound ``roofline`` on this package to the MODULE,
        # but the API exports the function under that name
        if sub == "roofline":
            globals()["roofline"] = mod.roofline
        globals()[name] = getattr(mod, name)
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
