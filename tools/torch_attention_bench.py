"""The flash-attention kernel of ``csrc/flash_attention.cu`` on the card at
the main path's two attention widths, k = 0, mode fp, f32, causal:
gemma-2b's (B=1, H=8, KH=1, seq 4096, hd 256; ``chip_smoke.GEMMA_ATTENTION``)
and Qwen3-30B-A3B's (B=1, H=32, KH=4, seq 4096, hd 128;
``chip_smoke.MAIN_ATTENTION``), and with ``--widths`` phase 3's hd-256
cases (B=2, H=8, KH=2, seq 512: ``p3``, ``p3_bf16``, ``p3_window`` and
``p3_window_bf16`` at window 128, ``p3_seq24``). It prints

* the registers, spills and shared memory of every kernel instance of the
  source (``nvcc -Xptxas -v``, the run-time build);
* with ``--check``: the hd-256 kernel against its plain version in every
  mode at k in {0, 1, 24}, f32 and bf16, at phase 3's hd-256 shapes
  (``chip_smoke.ATTENTION_CASES``) and at gemma-2b's widths: fp and vmem
  ``nacc`` bitwise, mxu's within TF32, outputs row by row within
  ``ref.TF32_ROW_TOL``;
* for each width: the kernel's event ms (``chip_smoke.time_ms``, median
  of 25) and device ms (``chip_smoke.device_ms``), the plain version's
  event ms, the bound (``chip_smoke._attention_work``: operations at the
  TF32 peak, bytes at 3.35 TB/s), and, causal without a window, three
  SDPA yardsticks on the same inputs (f32, TF32 allowed, bf16), event and
  device ms,

then one ``ATTN {json}`` line with every number and the card's name and
power limit. Run from a checkout's root on a machine with a card:

    python3 tools/torch_attention_bench.py [--src DIR] [--build-only]
                                           [--check] [--widths gemma,qwen]
                                           [--no-sdpa]

``--src``: the ``src`` directory of the checkout to measure (default: this
checkout's), so that one call can time a parent and a change with the same
script: build both (``--build-only``, started together), then time them in
turns, a process a tree (parent, change, change, parent). Only
``flash_attention.cu`` is built, into ``build/attn_bench/`` beside that
``src`` (``torch_triad_bench.load_tree``).
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_triad_bench import ROOT, load_tree  # noqa: E402

SOURCES = ("flash_attention",)
CHECK_KS = (0, 1, 24)


def _widths(cs) -> dict:
    """Each width: the attention region's sizes, and for phase 3's other
    hd-256 cases a window or dtype the kernel is called with."""
    p3 = {"batch": 2, "heads": 8, "kv_heads": 2, "seq": 512, "head_dim": 256}
    return {"gemma": cs.GEMMA_ATTENTION, "qwen": cs.MAIN_ATTENTION,
            # phase 3's hd-256 cases
            "p3": p3, "p3_bf16": {**p3, "dtype": "bfloat16"},
            "p3_window": {**p3, "window": 128},
            "p3_window_bf16": {**p3, "window": 128, "dtype": "bfloat16"},
            "p3_seq24": {**p3, "seq": 24}}


def _registers(_build) -> dict:
    usage = _build.ptxas_usage("flash_attention")
    for name, (regs, st, ld) in sorted(usage.items()):
        print(f"ptxas {name}: {regs} registers, spills {st}/{ld}", flush=True)
    return usage


def _check(cs) -> list:
    """Failures of the hd-256 kernel against its plain version (empty when
    every case holds)."""
    import torch

    from repro_torch.kernels.noisy_matmul.ref import default_noise_operand

    failures, max_err = [], {}
    dev = torch.device("cuda")
    noise = default_noise_operand(dev)
    for i, (label, hd, dtype, seq, causal, window, _) in enumerate(
            cs.ATTENTION_CASES):
        if hd != 256:
            continue
        q, k, v = cs._attention_inputs(dev, 2, 8, 2, seq, hd,
                                       getattr(torch, dtype), seed=i)
        cs._check_cases({f"flash_attention_h256 ({label})": cs._attention_case(
                            q, k, v, noise, causal=causal, window=window)},
                        CHECK_KS, failures, max_err, full=False)
    cs._check_gemma_attention(failures, max_err)
    print(f"check: {len(failures)} failures; max|kernel - plain| {max_err}",
          flush=True)
    for f in failures:
        print(f"  FAILED {f}", flush=True)
    return failures


def _sdpa(cs, q, k, v) -> dict:
    """The three SDPA yardsticks on the kernel's inputs: event and device
    ms."""
    import torch

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (t.bfloat16() for t in (q, k, v))

    def tf32():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return sdpa(q, k, v, is_causal=True, enable_gqa=True)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    calls = {"f32": lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
             "tf32": tf32,
             "bf16": lambda: sdpa(qh, kh, vh, is_causal=True,
                                  enable_gqa=True)}
    return {name: {"event_ms": cs.time_ms(fn), "device_ms": cs.device_ms(fn)[0]}
            for name, fn in calls.items()}


def _time(cs, name: str, width: dict, sdpa: bool) -> dict:
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain, flash_attention_rt)
    from repro_torch.kernels.region import pallas_region

    import torch

    window = width.get("window", 0)
    sizes = {n: v for n, v in width.items() if n not in ("window", "dtype")}
    q, k, v, noise = pallas_region("attention", **sizes).args_for_rt("fp")
    q, k, v = (t.to(getattr(torch, width.get("dtype", "float32")))
               for t in (q, k, v))

    def kern():
        return flash_attention_rt(0, q, k, v, noise, mode="fp", window=window)

    nbytes, nops = cs._attention_work(q, k, window=window)
    bound = max(nbytes / cs.HBM_BYTES_PER_S, nops / cs.TF32_FLOPS) * 1e3
    dev_ms, per_kernel, n_kernels, whole = cs.device_ms(kern)
    out = {"width": width, "event_ms": cs.time_ms(kern), "device_ms": dev_ms,
           "device_per_kernel": per_kernel, "kernels_per_call": n_kernels,
           "device_records_whole": whole,
           "plain_ms": cs.time_ms(lambda: flash_attention_plain(
               q, k, v, noise, mode="fp", k_noise=0, window=window), reps=3,
               warmup=1),
           "bound_ms": bound, "bytes": nbytes, "operations": nops,
           "bound_share": bound / dev_ms if dev_ms else None}
    if sdpa and not window:
        out["sdpa"] = _sdpa(cs, q, k, v)
    print(f"{name} {width}: event {out['event_ms']!r} ms, device "
          f"{dev_ms!r} ms ({per_kernel}), plain {out['plain_ms']!r} ms, "
          f"bound {bound!r} ms ({out['bound_share']!r} of it on the device)"
          + (f"; SDPA {out['sdpa']}" if "sdpa" in out else ""), flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory of the checkout to measure")
    ap.add_argument("--build-only", action="store_true",
                    help="build flash_attention.cu and stop")
    ap.add_argument("--check", action="store_true",
                    help="hold the hd-256 kernel against its plain version "
                         "first; exit 1 on a failure")
    ap.add_argument("--widths", default="gemma,qwen",
                    help="comma-separated widths to time (gemma, qwen, "
                         "p3, p3_bf16, p3_window, p3_window_bf16, "
                         "p3_seq24)")
    ap.add_argument("--no-sdpa", action="store_true",
                    help="skip the SDPA yardsticks")
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    _build = load_tree(src, SOURCES, os.path.join(
        os.path.dirname(src), "build", "attn_bench"))
    _build.runtime_lib()
    if args.build_only:
        print(f"built {SOURCES} for {src}", flush=True)
        return

    import chip_smoke as cs
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"{src}: {card}", flush=True)
    result = {"src": src, "card": card, "registers": _registers(_build)}
    if args.check:
        result["failures"] = _check(cs)
    widths = _widths(cs)
    result["timings"] = {name: _time(cs, name, widths[name], not args.no_sdpa)
                         for name in args.widths.split(",") if name}
    print("ATTN " + json.dumps(result, default=str), flush=True)
    if result.get("failures"):
        sys.exit(1)


if __name__ == "__main__":
    main()
