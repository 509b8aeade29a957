"""Serving example, in the PyTorch port: batched generation with continuous
batching on a small dense LM — prefill builds the KV cache in one pass,
finished slots are refilled from the queue without stalling the decode
batch.

    PYTHONPATH=src python examples/torch_serve_lm.py                # card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu

The reference's workload (``examples/serve_lm.py``): deepseek_coder_33b's
smoke config with weights from seed 0, ``ServeEngine(n_slots=4,
max_seq=128, temperature=0.0)``, 10 requests from ``RandomState(7)``
(prompts of 2-15 tokens, max_new 24).
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.region import resolve_device
from repro_torch.models.model import build
from repro_torch.serve import ServeEngine

ARCH = "deepseek_coder_33b"
N_SLOTS, MAX_SEQ, MAX_NEW = 4, 128, 24


def prompts(vocab_size: int) -> list:
    """The reference's request stream: 10 prompts of 2-15 tokens from
    ``RandomState(7)``."""
    rng = np.random.RandomState(7)
    out = []
    for _ in range(10):
        plen = int(rng.randint(2, 16))
        out.append(rng.randint(0, vocab_size, size=plen).tolist())
    return out


def serve(api, params) -> tuple:
    """Serve the request stream greedily on ``params``: (requests, seconds
    of ``engine.run()``)."""
    engine = ServeEngine(api, params, n_slots=N_SLOTS, max_seq=MAX_SEQ,
                         temperature=0.0)
    requests = [engine.submit(p, max_new=MAX_NEW)
                for p in prompts(api.cfg.vocab_size)]
    t0 = time.perf_counter()
    engine.run()
    return requests, time.perf_counter() - t0


def main(argv=None):
    """Build the smoke model on the device, serve, print tok/s and the
    first three requests."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default): the model on the card; cpu: on "
                         "the CPU")
    args = ap.parse_args(argv)
    resolve_device(args.device)      # no card: refuse, never the CPU
    api = build(get_smoke_config(ARCH))
    params = api.init(0, args.device)
    requests, dt = serve(api, params)
    total = sum(len(r.out) for r in requests)
    print(f"served {len(requests)} requests on {N_SLOTS} slots: {total} "
          f"tokens "
          f"in {dt:.2f}s ({total / dt:.1f} tok/s, continuous batching)")
    for r in requests[:3]:
        print(f"  req{r.uid}: prompt[:4]={r.prompt[:4]} -> "
              f"out[:8]={r.out[:8]}")
    assert all(r.done for r in requests)
    return requests, dt


if __name__ == "__main__":
    main()
