"""The port's serving engine (``engine``) and its load harness and serve
regions (``load``)."""
from repro_torch.serve.engine import Request, ServeEngine  # noqa: F401

_LOAD_EXPORTS = ("LoadSpec", "MIXES", "run_load", "sample_requests")


def __getattr__(name):
    # lazy: `python -m repro_torch.serve.load` warns if the package __init__
    # has already imported the submodule eagerly
    if name in _LOAD_EXPORTS:
        from repro_torch.serve import load
        return getattr(load, name)
    raise AttributeError(name)
