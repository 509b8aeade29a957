"""Profile ``examples/torch_quickstart.py`` on the card: build the run-time
library and one static loop build, time them, then run the example's
``main`` at its defaults under cProfile and print the 45 costliest calls
by cumulative time.

    python3 tools/torch_profile_quickstart.py     # from a checkout's root

Needs a CUDA card and ``nvcc``. cProfile charges every Python call, so
use it to find where the time goes, not to time the example.
"""
import cProfile
import io
import os
import pstats
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    """Time the builds, then profile the quickstart."""
    sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "examples")]
    from repro_torch.core.loopnoise import MODE_IDS
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.runtime_lib()
    print(f"runtime library: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    path = _build.static_build("loop_regions", MODE_IDS["fp_add"], 320)
    print(f"one static loop build: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    _build.sass_dump(path)
    print(f"its cuobjdump: {time.perf_counter() - t0:.1f} s", flush=True)

    import torch_quickstart

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    torch_quickstart.main([])
    prof.disable()
    print(f"quickstart: {time.perf_counter() - t0:.1f} s", flush=True)
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(45)
    print(out.getvalue())


if __name__ == "__main__":
    main()
