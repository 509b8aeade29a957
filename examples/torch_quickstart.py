"""Quickstart, in the PyTorch port: the paper's technique in a few lines.

Characterize two kernels with noise injection — a memory-bound STREAM triad
and a compute-bound HACCmk force kernel — and read the absorption metric
of each (paper Fig. 5 in miniature). On the card each is one CUDA kernel
with the noise slot in its loop body (``csrc/loop_regions.cu``:
``stream_kernel`` and ``haccmk_kernel``).

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu \\
        --stream-n 4096 --haccmk-iters 200                            # plain

The sizes are the reference's (``examples/quickstart.py``); ``--device
cpu`` runs the kernels' plain PyTorch versions, where HACCmk's 60,000
iterations are 60,000 Python steps a call, hence the size flags. The
closing reading is derived from the labels this run computed: it states
no finding of its own.

Only public entry points are used (the regions of
``repro_torch.bench.kernels`` and ``repro_torch.core.controller.Controller``);
docs/port.md maps every paper section to the port's module and command.
"""
import argparse

from repro_torch.bench.kernels import haccmk_region, stream_region
from repro_torch.core.controller import Controller

MODES = ("fp_add", "l1_ld", "mem_ld")


def characterize(*, device="cuda", stream_n=1 << 22,
                 haccmk_iters=60_000) -> dict:
    """{"stream": RegionReport, "haccmk": RegionReport}: both regions
    characterized over fp_add, l1_ld and mem_ld, their summaries
    printed."""
    ctl = Controller(reps=3)
    reports = {}
    for key, title, target in (
            ("stream", "memory-bound kernel (STREAM triad):",
             lambda: stream_region(n=stream_n, device=device)),
            ("haccmk", "compute-bound kernel (HACCmk):",
             lambda: haccmk_region(n_iter=haccmk_iters, device=device))):
        print(("\n" if reports else "") + title, flush=True)
        rep = ctl.characterize(target(), modes=MODES)
        print(rep.summary(), flush=True)
        reports[key] = rep
    return reports


def reading(reports: dict) -> str:
    """One line read off the computed labels: each region's label and the
    mode that absorbed least (the first noise to cost it time)."""
    parts = []
    for key, name in (("stream", "STREAM triad"), ("haccmk", "HACCmk")):
        rep = reports[key]
        absorbed = rep.absorptions()
        first = min(absorbed, key=absorbed.get)
        parts.append(f"{name} -> {rep.bottleneck.label} (least absorbed: "
                     f"{first}, Abs^raw={absorbed[first]:.1f})")
    return "reading: " + "; ".join(parts)


def main(argv=None):
    """Parse the flags, characterize both regions, print the reading."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default): the CUDA kernels; cpu: their "
                         "plain PyTorch versions")
    ap.add_argument("--stream-n", type=int, default=1 << 22,
                    help="STREAM triad length (the reference's 2^22)")
    ap.add_argument("--haccmk-iters", type=int, default=60_000,
                    help="HACCmk iterations (the reference's 60,000)")
    args = ap.parse_args(argv)
    reports = characterize(device=args.device, stream_n=args.stream_n,
                           haccmk_iters=args.haccmk_iters)
    print("\n" + reading(reports))
    return reports


if __name__ == "__main__":
    main()
