"""The graph-noise emitters (``csrc/graph_noise.cu``) on the CPU:

* vmem_ld's stepped offsets (``ref.vmem_offsets``: a chain a ring slot,
  each step wrapped once) are the reference's (j * 13) % max(rows - 8, 1)
  for every rows the kernel takes and every k up to ``LOOP_K_MAX``; the
  rows ``gvmem_kernel`` stages hold every row its patterns read; its ring
  of ``ref.VMEM_RING`` loads (``vmem_patterns``, ``stream_patterns``'
  schedule) loads every pattern's offset once and in order and adds each
  pattern once in order into chain j % 4, so its accumulators are
  ``vmem_ld_plain``'s bit for bit;
* the cluster epilogue of ``gfp_kernel`` and ``gvmem_kernel``: mirrors of
  ``warp0_tree_sum`` (the block tree behind one barrier) and
  ``cluster_aux`` (rank 0's sum of one to eight block sums) are
  ``reduce_threads`` and its block-sum stage bit for bit, on random
  values and on signed zeros (all -0 included); ``fp_cluster`` picks the
  cluster for grids of at most ``ref.CLUSTER_MAX`` blocks and the ticket
  beyond;
* a Python model of ``gstream_kernel``'s schedule (``stream_patterns``: a
  ring of ``ref.STREAM_RING`` loads in flight a thread, full trips of R
  patterns while two trips remain, the tile index stepped by 197 %
  n_tiles and wrapped once) loads every pattern's tile (j*197) % n_tiles
  once and in order, R patterns before the one that adds it, with at most
  R loads in flight, and adds each pattern once in the reference's order,
  so its acc is ``hbm_stream_plain``'s bit for bit; a ring bound one
  pattern short fails the same checks;
* the ring and block constants of ``graph_noise.cu`` are ``ref.py``'s;
* ``mxu_fma128_plain`` with a permutation c that is not its own transpose
  gives the reference's ``_mxu_apply`` and ``_mxu_apply_rt`` m bitwise
  (exact products), its aux within 1e-6 of the sum of magnitudes (the
  sums' orders differ, as in ``test_torch_graph_noise.py``);
* the card's stated tolerance at a random c (``ref.MXU_RANDOM_C_TOL``,
  2^-8 of the largest element a pattern) holds
  against the same products summed in another f32 order (chunks of 16,
  as the tensor cores take k); there the card holds the aux bitwise to
  ``ref.one_block_sum`` of its own m, which one bf16 step of one element
  moves;
* the SASS parser gives ``HGMMA`` its registers (the accumulator's 64, A's
  fragment of 4, B's descriptor half of the ``gdesc`` quad), and the
  payload census counts it as compute.
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import noise as ref_noise
from repro_torch.kernels.graph_noise import kernel as gk
from repro_torch.kernels.graph_noise import ref

CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "src", "repro_torch",
                    "csrc", "graph_noise.cu")
R = ref.STREAM_RING
STEP = 197


def _stream_schedule(k: int, n_tiles: int, ring: int = R,
                     trip_bound: int = 2 * R, stride: int = STEP,
                     add_first: bool = False) -> dict:
    """``stream_patterns`` as one thread runs it: the loads in issue order
    as (pattern, tile, the pattern added just before it was issued; -1 in
    the prologue), the patterns in the order they are added (with the ring
    slot that held each), and the most loads in flight. ``trip_bound``: a
    full trip runs while j + trip_bound <= k (the kernel's 2R).
    ``vmem_patterns`` runs the same schedule with its ring, stride 13 over
    m = n_tiles, and each slot's add before its next load
    (``add_first``)."""
    step = stride % n_tiles
    st = {"t": 0, "issued": 0, "added": -1, "loads": [], "adds": [],
          "slots": [], "in_flight": 0, "most": 0}

    def next_load():
        j = st["issued"]
        st["loads"].append((j, st["t"], st["added"]))
        st["issued"] += 1
        st["t"] += step
        if st["t"] >= n_tiles:
            st["t"] -= n_tiles
        st["in_flight"] += 1
        st["most"] = max(st["most"], st["in_flight"])
        return j

    def take(j):         # the value leaves the ring for a register
        st["in_flight"] -= 1
        return j

    def add(j, slot):
        st["adds"].append(j)
        st["slots"].append(slot)
        st["added"] = j

    r = [next_load() if i < k else None for i in range(ring)]
    j = 0
    while j + trip_bound <= k:
        for i in range(ring):
            if add_first:
                add(take(r[i]), i)
                r[i] = next_load()
                continue
            v = take(r[i])
            r[i] = next_load()
            add(v, i)
        j += ring
    for i in range(ring):
        if j + i < k:
            v = take(r[i])
            if add_first:
                add(v, i)
            if j + ring + i < k:
                r[i] = next_load()
            if not add_first:
                add(v, i)
    for i in range(ring):
        if j + ring + i < k:
            add(take(r[i]), i)
    return st


def _check_schedule(st: dict, k: int, n_tiles: int) -> None:
    assert [j for j, _, _ in st["loads"]] == list(range(k))
    assert [t for _, t, _ in st["loads"]] == [(j * STEP) % n_tiles
                                              for j in range(k)]
    assert [at for _, _, at in st["loads"]] == [
        j - R - 1 if j > R else -1 for j in range(k)]
    assert st["adds"] == list(range(k))
    assert st["most"] <= R and st["in_flight"] == 0


@pytest.mark.parametrize("n_tiles", (1, 13, 196, 197, 2048))
@pytest.mark.parametrize("k", (0, 1, R - 1, R, 64, 512 + 3))
def test_stream_schedule_is_the_references(k, n_tiles):
    """Every pattern's tile loaded once, in order, issued where pattern
    j - R - 1 was added (the load of j is issued in place of j - R, after
    j - R - 1's add: R loads in flight), each pattern added once in order;
    run on seeded tiles that order gives the plain version's acc and aux
    bit for bit."""
    st = _stream_schedule(k, n_tiles)
    _check_schedule(st, k, n_tiles)
    if k > 1 and STEP % n_tiles:     # 197 tiles: every pattern tile 0
        assert len({t for _, t, _ in st["loads"]}) > 1
    rng = np.random.default_rng(k * 7919 + n_tiles)
    tile = 2
    buf = torch.from_numpy(rng.standard_normal((n_tiles * tile, 128),
                                               dtype=np.float32))
    acc0 = torch.from_numpy(rng.standard_normal((tile, 128),
                                                dtype=np.float32))
    tiles = dict((j, t) for j, t, _ in st["loads"])
    acc = acc0.clone()
    for j in st["adds"]:
        t = tiles[j]
        acc = acc + buf[t * tile:(t + 1) * tile]
    aux, want = ref.hbm_stream_plain(buf, acc0, k=k, tile_rows=tile)
    assert torch.equal(acc, want)
    assert torch.equal(ref.reduce_threads(acc.reshape(-1), ref.THREADS), aux)


@pytest.mark.parametrize("k", (2 * R - 1, 3 * R - 1, 64 + R - 1))
def test_stream_schedule_model_catches_a_short_ring_bound(k):
    """The checks above fail a schedule whose full trips run one pattern
    too long (j + 2R - 1 <= k): its last trip loads a pattern past k."""
    st = _stream_schedule(k, 13, trip_bound=2 * R - 1)
    with pytest.raises(AssertionError):
        _check_schedule(st, k, 13)


# vmem_ld: the buffer rows the kernel takes, and its k up to LOOP_K_MAX
VMEM_ROWS = range(8, gk.MAX_VMEM_ROWS + 1)
K_MAX = 512
VR = ref.VMEM_RING


def _stage_rows(rows: int, k: int) -> int:
    """``vmem_stage_rows``: the rows gvmem_kernel stages for k >= 1
    patterns, min(13 (k - 1), m - 1) + 8."""
    m = max(rows - 8, 1)
    return min(13 * (k - 1), m - 1) + 8


@pytest.mark.parametrize("lo", range(VMEM_ROWS.start, VMEM_ROWS.stop, 64))
def test_vmem_offsets_step_to_the_references(lo):
    """For every rows of the kernel (a block of 64 a case) and every k up
    to LOOP_K_MAX: the offsets stepped as gvmem_kernel steps them (a
    chain a ring slot, ``ref.vmem_offsets``) are the reference's (i * 13)
    % max(rows - 8, 1) (``src/repro/core/noise.py`` `_vmem_apply` and
    `_vmem_apply_rt`), and the staged rows hold every row the k patterns
    read, within the buffer."""
    from repro_torch.kernels.noise_slots import K_MAX as CARD_K_MAX

    assert CARD_K_MAX == K_MAX
    for rows in range(lo, min(lo + 64, VMEM_ROWS.stop)):
        got = ref.vmem_offsets(rows, K_MAX)
        assert got == [(i * 13) % max(rows - 8, 1) for i in range(K_MAX)]
        top = 0
        for k in range(1, K_MAX + 1):
            top = max(top, got[k - 1] + 8)
            assert top <= _stage_rows(rows, k) <= rows


@pytest.mark.parametrize("rows", (8, 9, 21, 64, 448))
@pytest.mark.parametrize("k", (0, 1, 3, VR - 1, VR, 2 * VR - 1, 2 * VR, 64,
                               K_MAX))
def test_vmem_schedule_is_the_references(k, rows):
    """``vmem_patterns`` (the stream schedule with a ring of VMEM_RING, each
    slot's add before its next load): every pattern's slice loaded once,
    in order, at the reference's offset, the load of pattern j >= R issued
    just after pattern j - R's add, R loads in flight at most, each
    pattern added once in order by ring slot j % R, so into chain j % 4;
    run on a seeded buffer that order gives ``vmem_ld_plain``'s
    accumulators and aux bit for bit."""
    assert VR % ref.N_CHAINS == 0
    m = max(rows - 8, 1)
    st = _stream_schedule(k, m, ring=VR, trip_bound=2 * VR, stride=13,
                          add_first=True)
    assert [j for j, _, _ in st["loads"]] == list(range(k))
    assert [t for _, t, _ in st["loads"]] == ref.vmem_offsets(rows, k)
    assert [at for _, _, at in st["loads"]] == [
        j - VR if j >= VR else -1 for j in range(k)]
    assert st["adds"] == list(range(k))
    assert st["slots"] == [j % VR for j in range(k)]
    assert st["most"] <= VR and st["in_flight"] == 0
    rng = np.random.default_rng(k * 7919 + rows)
    buf = torch.from_numpy(rng.standard_normal((rows, 128), dtype=np.float32))
    accs = tuple(torch.from_numpy(rng.standard_normal((8, 128),
                                                      dtype=np.float32))
                 for _ in range(ref.N_CHAINS))
    offs = dict((j, t) for j, t, _ in st["loads"])
    new = list(accs)
    for j, slot in zip(st["adds"], st["slots"]):
        ch = slot % ref.N_CHAINS
        new[ch] = new[ch] + buf[offs[j]:offs[j] + 8]
    aux, want = ref.vmem_ld_plain(buf, accs, k=k)
    assert all(torch.equal(a, b) for a, b in zip(new, want))
    assert torch.equal(ref.chains_aux(new), aux)


def _warp0_tree_sum(v: torch.Tensor) -> torch.Tensor:
    """``warp0_tree_sum`` over each row of 256 values: lane t of warp 0 adds
    ((v[t] + v[t+128]) + (v[t+64] + v[t+192])) + ((v[t+32] + v[t+160]) +
    (v[t+96] + v[t+224])), then the five shuffle levels s = 16, ..., 1."""
    c = [v[..., 32 * q:32 * (q + 1)] for q in range(8)]
    lane = (((c[0] + c[4]) + (c[2] + c[6]))
            + ((c[1] + c[5]) + (c[3] + c[7])))
    return ref.tree_sum(lane)


def _cluster_sum(block_sums: torch.Tensor) -> torch.Tensor:
    """``cluster_aux`` in rank 0: lane t < C holds 0 + s_t, lanes up to 7
    hold +0, then the levels s = 4, 2, 1."""
    lanes = torch.zeros(8, dtype=torch.float32)
    lanes[:block_sums.shape[0]] = torch.zeros(()) + block_sums
    return ref.tree_sum(lanes)


def _bits(t: torch.Tensor) -> int:
    return int(t.reshape(()).view(torch.int32))


def _values(kind: str, n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if kind == "random":      # magnitudes over twelve decades: order matters
        v = rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)
    elif kind == "signed zeros":
        v = rng.choice([0.0, -0.0, 1.5, -1.5, 2.0 ** -20], n)
    else:                     # all -0
        v = np.full(n, -0.0)
    return torch.from_numpy(v.astype(np.float32))


@pytest.mark.parametrize("kind", ("random", "signed zeros", "all -0"))
@pytest.mark.parametrize("blocks", range(1, ref.CLUSTER_MAX + 1))
def test_cluster_epilogue_is_reduce_threads(blocks, kind):
    """The cluster epilogue's two stages bit for bit (signs of zero
    included): rank 0's sum of ``blocks`` block sums against
    ``final_reduce`` (``reduce_blocks``' last block: ``reduce_threads``'
    block-sum stage), and the whole (each block's ``warp0_tree_sum``,
    then rank 0's) against ``reduce_threads`` of the threads' values."""
    from repro_torch.kernels.loop_regions.ref import final_reduce

    for seed in range(4):
        sums = _values(kind, blocks, seed)
        assert _bits(_cluster_sum(sums)) == _bits(
            final_reduce(sums, ref.THREADS))
        v = _values(kind, blocks * ref.THREADS, 100 + seed)
        trees = _warp0_tree_sum(v.reshape(blocks, ref.THREADS))
        assert all(_bits(a) == _bits(b) for a, b in zip(
            trees, ref.tree_sum(v.reshape(blocks, ref.THREADS))))
        assert _bits(_cluster_sum(trees)) == _bits(
            ref.reduce_threads(v, ref.THREADS))
    if kind == "all -0":     # 0 + (-0) is +0: the aux of -0s is +0
        assert _bits(_cluster_sum(_values(kind, blocks, 0))) == 0


@pytest.mark.parametrize("E,blocks,cluster", (
    (128, 1, True), (1024, 4, True), (2048, 8, True), (2049, 9, False),
    (24 * 128, 12, False)))
def test_fp_epilogue_path_by_E(E, blocks, cluster):
    """gfp_kernel's epilogue by shape: one cluster up to CLUSTER_MAX blocks
    (the ici modes' E = 128, the default scale's 1,024), the ticket of
    ``reduce_blocks`` beyond (a ``NoiseScale`` with vpu_rows > 16)."""
    assert gk._blocks(E) == blocks
    assert gk.fp_cluster(E) is cluster


def _define(name: str) -> int:
    with open(CSRC) as f:
        m = re.search(rf"^#define {name} (\d+)", f.read(), re.M)
    assert m, name
    return int(m.group(1))


def test_source_constants_are_refs():
    """The block, rings and cluster bound of graph_noise.cu are the plain
    versions' (the aux order follows the block; the schedule models above
    follow the rings; the path choice the bound), and the mxu kernel's
    width and vmem_ld's buffer bound are the wrapper's."""
    assert _define("G_THREADS") == ref.THREADS
    assert _define("G_STREAM_RING") == ref.STREAM_RING
    assert _define("G_VMEM_RING") == ref.VMEM_RING
    assert _define("G_CLUSTER_MAX") == ref.CLUSTER_MAX
    assert _define("VMEM_MAX_ROWS") == gk.MAX_VMEM_ROWS
    assert _define("MXU_D") == gk.MXU_DIM
    assert ref.STREAM_RING >= 8 and ref.VMEM_RING % ref.N_CHAINS == 0


def _permutation(n: int, seed: int) -> np.ndarray:
    perm = np.random.default_rng(seed).permutation(n)
    p = np.zeros((n, n), np.float32)
    p[np.arange(n), perm] = 1.0
    assert not np.array_equal(p, p.T)
    return p


@pytest.mark.parametrize("k", (0, 1, 5))
def test_mxu_plain_at_a_permutation_is_the_references(k):
    """A non-symmetric permutation c: every product is exact, so m is the
    reference's bit for bit through ``_mxu_apply`` and ``_mxu_apply_rt``,
    and a c read transposed would not be (the card's check of B's
    layout)."""
    rng = np.random.default_rng(11)
    m = jnp.asarray(rng.standard_normal((128, 128), np.float32),
                    jnp.bfloat16)
    c = jnp.asarray(_permutation(128, 12), jnp.bfloat16)
    tm = torch.from_numpy(np.asarray(m, np.float32)).to(torch.bfloat16)
    tc = torch.from_numpy(np.asarray(c, np.float32)).to(torch.bfloat16)
    aux, got = ref.mxu_fma128_plain(tm, tc, k=k)
    for apply in (ref_noise._mxu_apply, ref_noise._mxu_apply_rt):
        raux, rstate = apply({"m": m, "c": c}, k)
        want = np.asarray(rstate["m"], np.float32)
        np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)
        assert abs(float(aux) - float(raux)) <= 1e-6 * float(
            np.abs(want).sum())
    if k:
        _, transposed = ref.mxu_fma128_plain(tm, tc.T.contiguous(), k=k)
        assert not torch.equal(transposed, got)


def _mxu_chunked(m, c, k: int, chunk: int = 16):
    """k chained bf16(m @ c) with each product's f32 sum taken over chunks
    of ``chunk`` of k in turn: another order of the same f32 adds."""
    cf = c.to(torch.float32)
    for _ in range(k):
        mf = m.to(torch.float32)
        acc = torch.zeros(mf.shape[0], cf.shape[1], dtype=torch.float32)
        for s in range(0, mf.shape[1], chunk):
            acc = acc + mf[:, s:s + chunk] @ cf[s:s + chunk]
        m = acc.to(torch.bfloat16)
    return ref.one_block_sum(m), m


@pytest.mark.parametrize("k", (1, 5, 24))
def test_random_c_tolerance_covers_another_sum_order(k):
    """The card's random-c check (``ref.MXU_RANDOM_C_TOL``): m
    within k x 2^-8 of the largest element of the plain version's, against
    the same products summed in chunks of 16 (the products themselves
    differ). Its aux is held bitwise to ``one_block_sum`` of the card's own
    m: one bf16 step of one element of that m changes it."""
    tol = k * ref.MXU_RANDOM_C_TOL
    g = torch.Generator().manual_seed(k)
    m = torch.randn(128, 128, generator=g).to(torch.bfloat16)
    c = (torch.randn(128, 128, generator=g) / 128 ** 0.5).to(torch.bfloat16)
    _, want = ref.mxu_fma128_plain(m, c, k=k)
    oaux, got = _mxu_chunked(m, c, k)
    err = float((got.float() - want.float()).abs().max())
    assert 0 < err <= tol * float(want.float().abs().max())
    stepped = got.clone()
    stepped.view(torch.int16).view(-1)[int(got.float().abs().argmax())] += 1
    assert not torch.equal(ref.one_block_sum(stepped), oaux)


# the run-time gmxu_kernel's pattern loop as cuobjdump prints it on the
# H100 (sm_90a), cut to the loop and the branch that closes it
HGMMA_SASS = """
        Function : _Z11gmxu_kernelILin1EEvPK13__nv_bfloat16S2_PS0_Pfi
        /*0bd0*/                   WARPGROUP.ARRIVE ;
        /*0be0*/                   UIADD3.64 UR22, UR6, 0x200, URZ ;
        /*0bf0*/                   UIADD3 UR4, UR4, 0x1, URZ ;
        /*0c00*/                   HGMMA.64x128x16.F32.BF16 R24, R88, gdesc[UR4].tnspB, RZ, !UPT ;
        /*0c10*/                   ISETP.LE.AND P0, PT, R4, UR4, PT ;
        /*0c20*/                   HGMMA.64x128x16.F32.BF16 R24, R92, gdesc[UR8].tnspB, R24 ;
        /*0cb0*/                   HGMMA.64x128x16.F32.BF16 R24, R116, gdesc[UR20].tnspB, R24, gsb0 ;
        /*0cc0*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
        /*0cd0*/                   F2FP.BF16.F32.PACK_AB R88, R25, R24 ;
        /*0ed0*/              @!P0 BRA 0xbd0 ;
"""


def test_sass_parser_reads_hgmma_registers():
    from repro_torch.sass.parse import parse_instr, parse_sass

    (fn,) = parse_sass(HGMMA_SASS).values()
    first, second, last = [i for i in fn.instrs if i.op == "HGMMA"]
    acc = tuple(f"R{24 + j}" for j in range(64))
    assert first.dst == acc and second.dst == acc and last.dst == acc
    # A's fragment (4 registers), B's descriptor (the quad's upper half:
    # UR4 is the loop's counter, not read), no accumulator at scale-d 0
    assert first.src == ("R88", "R89", "R90", "R91", "UR6", "UR7")
    assert second.src == ("R92", "R93", "R94", "R95", "UR10", "UR11", *acc)
    assert last.src[:6] == ("R116", "R117", "R118", "R119", "UR22", "UR23")
    assert all(i.depth == 1 for i in fn.instrs)
    pack = next(i for i in fn.instrs if i.op == "F2FP")
    assert pack.src == ("R25", "R24")
    # the descriptor of a product with A in shared memory: the whole quad
    ss = parse_instr(0, "HGMMA.64x128x8.F32.TF32 R24, gdesc[UR4], R24")
    assert ss.src == ("UR4", "UR5", "UR6", "UR7", *acc)
    f16 = parse_instr(0, "HGMMA.64x64x16.F16.F16 R8, R0, gdesc[UR4], R8")
    assert len(f16.dst) == 16


def test_census_counts_hgmma_as_compute_payload():
    from repro_torch.core.payload import (PAYLOAD_OPS, analyze_injection,
                                          census_op)

    assert census_op("HGMMA.64x128x16.F32.BF16") == "HGMMA"
    assert "HGMMA" in PAYLOAD_OPS["compute"]
    clean = HGMMA_SASS.replace(
        "        /*0c20*/                   HGMMA.64x128x16.F32.BF16 R24, "
        "R92, gdesc[UR8].tnspB, R24 ;\n", "")
    rep = analyze_injection(clean, HGMMA_SASS, mode="mxu_fma128",
                            target="compute", expected=1)
    assert (rep.payload, rep.overhead) == (1, 0)
