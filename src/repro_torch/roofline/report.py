"""Render the roofline table of every dry-run cell from its records.

    PYTHONPATH=src python -m repro_torch.roofline.report \\
        [--dir experiments/dryrun_torch/16x16] [--tag TAG]

PyTorch port of the reference's ``repro.roofline.report``. The useful
fraction is taken against the peak each record names
(``roofline.peak_flops``: the H100 SXM data sheet's dense rate of the
model's compute dtype), so every fraction is a prediction.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import ARCHS, SHAPES

_ADVICE = {
    ("memory", "train"): "fuse attention (online softmax) — stop "
                         "materializing S x S score tensors through HBM",
    ("memory", "prefill"): "fuse attention (online softmax) + causal block "
                           "skipping",
    ("memory", "decode"): "cache is streamed once per token (bandwidth "
                          "floor) — shrink it: GQA is in place, add KV "
                          "quantization",
    ("compute", "train"): "causal block skipping halves attention flops; "
                          "remat=dots avoids recompute",
    ("compute", "prefill"): "causal block skipping halves attention flops",
    ("compute", "decode"): "decode flops are already minimal — batch more "
                           "requests per step",
    ("ici", "train"): "reduce-scatter instead of all-reduce for grads; bf16 "
                      "or int8-compressed gradient reduction",
    ("ici", "prefill"): "shard the sequence dim instead of gathering "
                        "activations",
    ("ici", "decode"): "keep the cache model-sharded; all-gather logits "
                       "hierarchically (pod-local first)",
}


def load_records(d: str) -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def fmt_ms(s: float) -> str:
    return f"{s*1e3:9.1f}"


def render(d: str, *, only_tag: str = "") -> str:
    recs = load_records(d)
    order = {a: i for i, a in enumerate(ARCHS)}
    sorder = {s: i for i, s in enumerate(SHAPES)}
    recs.sort(key=lambda r: (order.get(r["arch"], 99),
                             sorder.get(r["shape"], 9)))
    lines = [
        "| arch | shape | Tc (ms) | Tm (ms) | Ti (ms) | dominant | "
        "useful ratio | roofline frac | next lever |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    skips = []
    fails = []
    for r in recs:
        if (r.get("tag") or "") != only_tag:
            continue
        if r["status"] == "skip":
            skips.append(f"- `{r['arch']} x {r['shape']}`: {r['reason']}")
            continue
        if r["status"] != "ok":
            fails.append(f"- `{r['arch']} x {r['shape']}`: {r.get('error')}")
            continue
        rf = r["roofline"]
        dom = rf["dominant"]
        kind = r.get("kind", "train")
        bound = max(rf["t_compute"], rf["t_memory"], rf["t_ici"])
        useful_t = (rf["model_flops_total"] / rf["n_chips"]) / rf["peak_flops"]
        frac = useful_t / bound if bound else 0.0
        frac_s = f"{frac:.1%}"
        if kind == "decode":
            # decode is bandwidth-bound by nature: its roofline metric is
            # the bandwidth fraction — params+cache read once vs modeled
            # traffic (MFU is ~0 by construction for 1-token steps).
            args = r.get("memory", {}).get("argument_size_in_bytes") or 0
            bw = args / rf["hbm_bytes_per_chip"] if rf["hbm_bytes_per_chip"] \
                else 0.0
            frac_s = f"bw {bw:.0%}"
        advice = _ADVICE.get((dom, kind), "")
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_ms(rf['t_compute'])} | "
            f"{fmt_ms(rf['t_memory'])} | {fmt_ms(rf['t_ici'])} | {dom} | "
            f"{rf['useful_ratio']:.2f} | {frac_s} | {advice} |")
    out = "\n".join(lines)
    if skips:
        out += "\n\nSkipped cells (per assignment rules):\n" + "\n".join(skips)
    if fails:
        out += "\n\nFAILED cells:\n" + "\n".join(fails)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.roofline.report",
        description="the roofline table of the dry-run records in --dir")
    ap.add_argument("--dir", default="experiments/dryrun_torch/16x16")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    print(render(args.dir, only_tag=args.tag))


if __name__ == "__main__":
    main()
