"""Tensor parallelism over ``model`` for the transformer family
(``parallel/sharding.py``'s ``copy_to_model`` and ``reduce_from_model``,
the split layers of ``models/``, ``train/trainer.py``'s ``tp_leaves``,
``serve/mesh.py``) on the CPU.

On 2 and 4 ``gloo`` ranks (``tests/torch_mesh_ranks.py``, target
``tensor_parallel``), gemma-2b's f32 smoke config (4 heads on 1 KV head,
``ff`` 128, vocabulary 256) on a (1, 2) and a (1, 4) (data, model) mesh:

* no leaf that ``resolve`` splits over ``model`` is gathered over
  ``model`` in a mesh step, the mesh prefill or the decode (every
  ``gather_shard`` call recorded), and the split leaves are the
  embedding, the attention's ``wq`` and ``wo`` and the MLP;
* the replicated leaves' gradients (the norms, the whole ``wk`` and
  ``wv``) are bitwise equal across the ``model`` ranks, and so are those
  params after the step; the split leaves' gradients, gathered, are the
  one-rank whole gradients within ``GRAD_RTOL`` of each leaf's largest;
* one forward issues two all-reduces a layer, one for the embedding and
  three for the vocab-parallel loss;
* the mesh prefill's and decode's logits (gathered over ``model`` at the
  end) are one rank's within ``LOGIT_ATOL``;
* the vocab-parallel ``softmax_xent`` is within ``XENT_TOL`` of the plain
  one, value and gradient, with and without a mask.

Without ranks: ``tp_leaves`` by family and mesh, ``without_axes``, and
the dry-run's gemma-2b ``train_4k`` record on 16 x 16, whose FLOPs a
rank, useful ratio and temp bytes the split brings under the bounds that
replicating the ``ff`` and vocabulary compute over 16 ranks could not
meet. The mesh step, prefill and decode against the reference's own
programs on (1, 4) and (2, 2) are in ``tests/test_torch_mesh_train.py``
and ``test_torch_mesh_serve.py``.
"""
import os

import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro_torch import configs
from repro_torch.models.model import build
from repro_torch.parallel import sharding as sh
from repro_torch.train import trainer as tr

WORLDS = (2, 4)
XENT_TOL = 1e-6
GRAD_RTOL = 1e-5
LOGIT_ATOL = 1e-5
# gemma-2b train_4k on 16 x 16 (ROADMAP): under half the replicated
# program's 1.3244e15 FLOPs a rank, twice its useful ratio of 0.0465,
# and less temp than its 57.75 GB
TRAIN_4K_FLOPS_MAX = 6.6e14
TRAIN_4K_USEFUL_MIN = 0.093
TRAIN_4K_TEMP_MAX = 57.75e9


def _xent_inputs() -> dict:
    rng = np.random.RandomState(3)
    return {"logits": (rng.randn(3, 5, 64) * 4).astype(np.float32),
            "labels": rng.randint(0, 64, (3, 5)).astype(np.int64),
            "mask": (rng.rand(3, 5) > 0.3).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tensor_parallel"))
    args = {"xent": _xent_inputs()}
    return {w: ranks.spawn(w, "tensor_parallel", args,
                           os.path.join(tmp, f"w{w}")) for w in WORLDS}


SPLIT = {"embed.table", *(f"layers.{i}.{leaf}" for i in range(2)
                          for leaf in ("attn.wq", "attn.wo", "mlp.w_gate",
                                       "mlp.w_up", "mlp.w_down"))}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("path", ("step", "prefill", "decode"))
def test_no_split_leaf_is_gathered_over_model(runs, world, path):
    for r in runs[world]:
        assert set(r["split"]) == SPLIT
        counts = r[f"{path}_over_model"]
        assert SPLIT <= counts.keys()
        assert {n: counts[n] for n in SPLIT} == dict.fromkeys(SPLIT, 0)


@pytest.mark.parametrize("world", WORLDS)
def test_replicated_gradients_are_bitwise_equal_across_model_ranks(runs,
                                                                   world):
    for r in runs[world]:
        eq = r["replicated_equal"]
        assert eq and SPLIT.isdisjoint(eq)
        assert {"layers.0.attn.wk", "layers.1.ln2.scale",
                "final_norm.scale"} <= eq.keys()
        assert all(eq.values()), [n for n, ok in eq.items() if not ok]
        assert all(r["params_equal"].values()), r["params_equal"]


@pytest.mark.parametrize("world", WORLDS)
def test_a_backward_on_another_thread_recomputes_the_split(runs, world):
    """CUDA's autograd engine runs the backward, and so the remat's
    recompute, on a thread of its own, where the active mesh of the
    caller's ``use_mesh`` is not set."""
    for r in runs[world]:
        eq = r["thread_equal"]
        assert eq.keys() == r["replicated_equal"].keys() | SPLIT
        assert all(eq.values()), [n for n, ok in eq.items() if not ok]


@pytest.mark.parametrize("world", WORLDS)
def test_split_gradients_gather_to_the_whole_gradient(runs, world):
    err = runs[world][0]["split_err"]
    assert err.keys() == SPLIT
    assert max(err.values()) <= GRAD_RTOL, err


@pytest.mark.parametrize("world", WORLDS)
def test_a_forward_issues_two_all_reduces_a_layer(runs, world):
    # 2 layers x (attention, MLP) + the embedding + the loss's max, sum of
    # exponentials and gold logit
    assert runs[world][0]["forward_all_reduces"] == 2 * 2 + 1 + 3


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_prefill_and_decode_equal_one_rank(runs, world):
    for r in runs[world]:
        assert r["prefill_err"] <= LOGIT_ATOL, r["prefill_err"]
        assert r["decode_err"] <= LOGIT_ATOL, r["decode_err"]
        assert r["logits_top"] > 0


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("masked", (False, True), ids=("plain", "masked"))
def test_vocab_parallel_xent_equals_the_plain_one(runs, world, masked):
    for r in runs[world]:
        got = r["xent"][masked]
        assert got["value"] <= XENT_TOL, got
        assert got["grad"] <= XENT_TOL, got


def _layout(arch: str, shape, smoke=True) -> tuple:
    cfg = (configs.get_smoke_config(arch) if smoke
           else configs.get_config(arch))
    api = build(cfg)
    params = api.init(0, "meta")
    mesh = sh.AbstractMesh(tuple(shape), ("data", "model"))
    shapes = {f"params/{n}": tuple(p.shape)
              for n, p in params.named_parameters()}
    logical = api.param_spec()
    specs = {k: sh.resolve(logical[k.split("/", 1)[1]], s, mesh)
             for k, s in shapes.items()}
    return api, sh.Layout(mesh, specs, shapes)


def test_tp_leaves_by_family_and_mesh():
    api, layout = _layout("gemma-2b", (1, 4))
    assert tr.tp_leaves(api, layout) == SPLIT
    assert tr.tp_leaves(*_layout("gemma-2b", (4, 1))) == frozenset()
    api, layout = _layout("qwen3-moe-30b-a3b", (1, 2))
    moe = tr.tp_leaves(api, layout)
    # the experts split over model by the rules, but compute replicated
    assert any(".moe." in k and sh.MODEL_AXIS in sh.entry_axes(e)
               for k, s in layout.specs.items() for e in s)
    assert not any(".moe." in n for n in moe)
    assert {"layers.0.attn.wk", "embed.table"} <= moe     # 2 KV heads
    for arch in ("mamba2-780m", "zamba2-1.2b", "whisper-large-v3"):
        assert tr.tp_leaves(*_layout(arch, (1, 4))) == frozenset(), arch
    # gemma-2b on 16 x 16: its 8 heads do not divide 16, ff and vocab do
    api, layout = _layout("gemma-2b", (16, 16), smoke=False)
    full = tr.tp_leaves(api, layout)
    assert "layers.0.attn.wq" not in full
    assert {"embed.table", "layers.0.mlp.w_down"} <= full


def test_without_axes():
    assert sh.without_axes(sh.P("data", "model"), ("model",)) == sh.P("data")
    assert sh.without_axes(sh.P("model", "data"), ("model",)) == \
        sh.P(None, "data")
    assert sh.without_axes(sh.P("data"), ("model",)) == sh.P("data")
    with pytest.raises(ValueError, match="cannot be kept"):
        sh.without_axes(sh.P(("data", "model")), ("model",))


def test_no_model_axis_without_a_live_mesh():
    assert sh.model_axis() == (None, 1, 0)
    with sh.use_mesh(sh.AbstractMesh((1, 4), ("data", "model"))):
        assert sh.model_axis() == (None, 1, 0)


def test_the_dry_run_train_4k_record_splits_ff_and_vocab(tmp_path):
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("gemma_2b", "train_4k", multi_pod=False,
                          out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    rf = rec["roofline"]
    assert rf["flops_per_chip"] <= TRAIN_4K_FLOPS_MAX, rf["flops_per_chip"]
    assert rf["useful_ratio"] >= TRAIN_4K_USEFUL_MIN, rf["useful_ratio"]
    temp = rec["memory"]["temp_size_in_bytes"]
    assert temp < TRAIN_4K_TEMP_MAX, temp
    # the model axis carries the split layers' all-reduces
    assert rf["collective_breakdown"]["all-reduce"] > 0
