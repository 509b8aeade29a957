"""End-to-end training, in the PyTorch port: train a dense LM for a few
hundred steps on the deterministic LCG next-token task, with checkpointing
and a simulated mid-run failure that the trainer recovers from.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--dim 512]
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20

The reference's flags, model and schedule (``examples/train_lm.py``): a
gemma-derived LM (2.4M parameters by default; ``--dim 768 --layers 12``
for the ~100M class: 109.3M), ``TrainConfig(lr=1e-3, warmup_steps=20,
ckpt_every=50)``, ``SyntheticPipeline(task="lcg")``, ``CheckpointManager
(keep=2)``. The failure comes at step ``steps // 2``: the trainer restores
the last checkpoint and replays the steps after it, on the same batches.
A checkpoint is saved after step s when (s + 1) is a multiple of
``--ckpt-every``, so a failure step that is such a multiple replays
nothing (200 steps fail at 100, where the last checkpoint is; 150 fail at
75 and replay 50-74). The same Trainer drives the full-size configs (see
``repro_torch.launch.train``).
"""
import argparse
import dataclasses
import os
import shutil

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import TrainConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.kernels.region import resolve_device
from repro_torch.models.model import build
from repro_torch.train.trainer import Trainer


def example_config(*, dim=192, layers=3, vocab=4096):
    """The reference's gemma-derived LM at ``dim`` x ``layers``."""
    return dataclasses.replace(
        get_config("gemma_2b"), name="example-lm",
        n_layers=layers, d_model=dim,
        n_heads=max(dim // 64, 1), n_kv_heads=max(dim // 128, 1),
        head_dim=64, d_ff=dim * 4, vocab_size=vocab)


def n_params(api) -> int:
    """The model's parameter count (its tree built on the meta device)."""
    return sum(p.numel() for p in api.init(0, "meta").parameters())


def train(cfg, *, steps=200, seq=96, batch=8, ckpt_dir,
          ckpt_every=50, inject_failure=True, device="cuda", state=None):
    """Train ``steps`` steps from ``state`` (default: the trainer's own
    from its seed) with checkpoints in ``ckpt_dir`` (emptied first) and a
    failure at ``steps // 2``: (state, history of every executed step,
    replays included)."""
    api = build(cfg)
    tcfg = TrainConfig(lr=1e-3, warmup_steps=20, total_steps=steps,
                       microbatches=1, ckpt_every=ckpt_every,
                       ckpt_dir=ckpt_dir)
    pipe = SyntheticPipeline(cfg, ShapeConfig("ex", "train", seq, batch),
                             task="lcg", device=device)
    if os.path.isdir(ckpt_dir):         # a stale checkpoint would be restored
        shutil.rmtree(ckpt_dir)
    ckpt = CheckpointManager(ckpt_dir, keep=2)
    trainer = Trainer(api, tcfg, ckpt_manager=ckpt, device=device)
    if state is None:
        state = trainer.init_state()

    crash = {"armed": inject_failure}

    def maybe_fail(step):
        if crash["armed"] and step == steps // 2:
            crash["armed"] = False
            print(f"*** simulated node failure at step {step} — the trainer "
                  "restores the last checkpoint and replays ***", flush=True)
            raise RuntimeError("node lost")

    return trainer.run(state, pipe, steps=steps, fail_injector=maybe_fail)


def replays(hist) -> list:
    """(step, first loss, replayed loss) of every step the history holds
    twice."""
    first, out = {}, []
    for h in hist:
        if h["step"] in first:
            out.append((h["step"], first[h["step"]], h["loss"]))
        else:
            first[h["step"]] = h["loss"]
    return out


def main(argv=None):
    """Parse the reference's flags (and ``--device``), train, print the
    loss trajectory."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200,
                    help="training steps")
    ap.add_argument("--dim", type=int, default=192, help="model width")
    ap.add_argument("--layers", type=int, default=3, help="model depth")
    ap.add_argument("--seq", type=int, default=96, help="tokens a sequence")
    ap.add_argument("--batch", type=int, default=8,
                    help="sequences a step")
    ap.add_argument("--vocab", type=int, default=4096,
                    help="vocabulary size")
    ap.add_argument("--ckpt-dir", default="experiments/ckpt_torch/train_lm",
                    help="checkpoint directory (emptied at the start)")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="save after step s when (s + 1) is a multiple")
    ap.add_argument("--inject-failure", action="store_true", default=True,
                    help="fail once at step steps // 2 (always on, as the "
                         "reference's)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default): train on the card; cpu: on the "
                         "CPU")
    args = ap.parse_args(argv)
    resolve_device(args.device)      # no card: refuse, never the CPU

    cfg = example_config(dim=args.dim, layers=args.layers, vocab=args.vocab)
    print(f"model: {cfg.n_layers}L d={cfg.d_model} "
          f"params={n_params(build(cfg)) / 1e6:.1f}M  task=lcg(next-token)",
          flush=True)
    state, hist = train(cfg, steps=args.steps, seq=args.seq,
                        batch=args.batch, ckpt_dir=args.ckpt_dir,
                        ckpt_every=args.ckpt_every,
                        inject_failure=args.inject_failure,
                        device=args.device)
    for h in hist:
        if h["step"] % 25 == 0 or h["step"] == args.steps - 1:
            print(f"step {h['step']:4d}  loss {h['loss']:7.4f}  "
                  f"gnorm {h['grad_norm']:6.2f}  {h['wall_s']*1e3:6.0f} ms")
    print(f"\nloss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} over "
          f"{len(hist)} executed steps (incl. replays)")
    again = replays(hist)
    if again:
        same = sum(a == b for _, a, b in again)
        print(f"replayed steps {again[0][0]}-{again[-1][0]}: {same}/"
              f"{len(again)} losses bitwise equal to their first run")
    return state, hist


if __name__ == "__main__":
    main()
