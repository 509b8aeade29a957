"""The port's loop-level noise emitters (``repro_torch.core.loopnoise``)
against the reference's (``repro.core.loopnoise``), on the reference's own
carries converted to tensors: every mode's ``emit`` and ``emit_rt`` at
k in {1, 5} and i in {3, 2^20 + 7} (where mem_ld's int32 offsets wrap)
within 1e-6, ``finalize`` likewise, the int32 offset arithmetic against
numpy's int32, the correctly rounded f32 FMA of fp_fma, and ``noisy_loop``.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.loopnoise import make_loop_modes as ref_modes
from repro.core.loopnoise import noisy_loop as ref_noisy_loop
from repro_torch.convert import carry_to_torch
from repro_torch.core import loopnoise as ln

MODES = ("fp_add", "fp_fma", "l1_ld", "mem_ld", "chase")
TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def ref_carries():
    modes = ref_modes()
    return {m: modes[m].init(jax.random.PRNGKey(0)) for m in MODES}


def _np_leaves(carry):
    out = []
    for key in sorted(carry):
        value = carry[key]
        for leaf in (value if isinstance(value, (tuple, list)) else (value,)):
            out.append(np.asarray(leaf))
    return out


def _ref_emit(mode, carry, k, i, rt):
    m = ref_modes()[mode]
    if rt:
        return jax.jit(lambda c, kk: m.emit_rt(c, kk, jnp.int32(i)))(
            carry, jnp.int32(k))
    return m.emit(carry, k, jnp.int32(i))


@pytest.mark.parametrize("rt", [False, True], ids=["emit", "emit_rt"])
@pytest.mark.parametrize("i", [3, 2 ** 20 + 7])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("mode", MODES)
def test_emit_matches_the_reference(ref_carries, mode, k, i, rt):
    want = _ref_emit(mode, ref_carries[mode], k, i, rt)
    port = ln.make_loop_modes()[mode]
    emit = port.emit_rt if rt else port.emit
    got = emit(carry_to_torch(ref_carries[mode]), k, i)
    assert sorted(got) == sorted(want)
    for g, w in zip(_np_leaves({key: tuple(v) if isinstance(v, tuple) else v
                                for key, v in got.items()}),
                    _np_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), w, **TOL)
    np.testing.assert_allclose(port.finalize(got).numpy(),
                               np.asarray(ref_modes()[mode].finalize(want)),
                               **TOL)


def test_registry_matches_the_reference():
    ref, port = ref_modes(), ln.make_loop_modes()
    assert list(port) == list(ref)
    for name in ref:
        assert port[name].target == ref[name].target
        assert port[name].payload_op == ref[name].payload_op
    from repro.core import loopnoise as rl
    assert ln.PAPER_LOOP_ALIASES == rl.PAPER_LOOP_ALIASES
    assert (ln.VEC, ln.L1_ROWS, ln.MEM_ROWS, ln.CHASE_LEN) == \
        (rl.VEC, rl.L1_ROWS, rl.MEM_ROWS, rl.CHASE_LEN)
    from repro.core.noise import N_CHAINS
    assert ln.N_CHAINS == N_CHAINS


@pytest.mark.parametrize("k", [1, 5, 320])
def test_offsets_are_int32_arithmetic(k):
    """l1_ld and mem_ld rows: int32 products that wrap, then a floor
    modulo, on ints and on int64 tensors alike."""
    i = np.array([0, 3, 2 ** 20 + 7, 2 ** 24 + 1, 2 ** 31 - 1, 123_456_789],
                 np.int64)
    for j in (0, 1, 7, k - 1):
        with np.errstate(over="ignore"):
            i32 = i.astype(np.int32)
            want_l1 = (i32 * np.int32(7) + np.int32(j * 13)) % np.int32(512)
            want_mem = ((i32 * np.int32(max(k, 1)) + np.int32(j))
                        * np.int32(40_503)) % np.int32(ln.MEM_ROWS)
        got_l1 = ln.l1_offset(torch.from_numpy(i), j).numpy()
        got_mem = ln.mem_offset(torch.from_numpy(i), k, j, ln.MEM_ROWS).numpy()
        np.testing.assert_array_equal(got_l1, want_l1)
        np.testing.assert_array_equal(got_mem, want_mem)
        assert [ln.mem_offset(int(v), k, j, ln.MEM_ROWS) for v in i] == \
            list(want_mem)
        assert (want_mem >= 0).all()


def _round_f32(x: Fraction) -> Fraction:
    """x rounded to the nearest float32 (ties to even), exactly."""
    lo = np.float32(float(x))
    for _ in range(3):           # step to the float32 at or below x
        if Fraction(float(lo)) > x:
            lo = np.nextafter(lo, np.float32(-np.inf))
    hi = np.nextafter(lo, np.float32(np.inf))
    d_lo, d_hi = x - Fraction(float(lo)), Fraction(float(hi)) - x
    if d_lo < d_hi or (d_lo == d_hi and int(lo.view(np.int32)) % 2 == 0):
        return Fraction(float(lo))
    return Fraction(float(hi))


def test_fma_is_rounded_once():
    """fma_f32(a, 0.999999, c) is the exactly rounded a*b + c (the card's
    FFMA), also where the f64 sum sits exactly between two floats."""
    rs = np.random.RandomState(0)
    a = (rs.standard_normal(400) * 10.0 ** rs.randint(-8, 4, 400)
         ).astype(np.float32)
    c = (rs.standard_normal(400) * 10.0 ** rs.randint(-8, 4, 400)
         ).astype(np.float32)
    cases = [(a, c, ln.FMA_MUL)]
    # the f64 sum lands exactly on the midpoint between an odd float c and
    # its neighbour, the exact value 2^-50 short of it: a*b = 2^-4 - 2^-50
    # with a = 2^-4 (1 - 2^-23), b = 1 + 2^-23; rounding the f64 sum would
    # pick the even neighbour, the one rounding keeps c (and its mirror)
    tie_a = np.float32(2.0 ** -4 * (1 - 2.0 ** -23))
    odd_c = np.float32(2.0 ** 20 + 2.0 ** -3)
    cases.append((np.array([tie_a, -tie_a], np.float32),
                  np.array([odd_c, -odd_c], np.float32), 1 + 2.0 ** -23))
    for a, c, b in cases:
        got = ln.fma_f32(torch.from_numpy(a), b, torch.from_numpy(c)).numpy()
        fb = Fraction(float(np.float32(b)))
        for x, y, r in zip(a, c, got):
            exact = Fraction(float(x)) * fb + Fraction(float(y))
            assert Fraction(float(r)) == _round_f32(exact), (x, y)
    assert got.tolist() == [odd_c, -odd_c]


def test_noisy_loop_composes():
    """The generic injection site wraps an arbitrary body (the reference's
    ``test_loop_noise_composition``)."""
    modes = ln.make_loop_modes()
    out, aux = ln.noisy_loop(lambda i, acc: acc + 1.0, 16,
                             torch.zeros((), dtype=torch.float32),
                             modes["fp_add"], k=2)
    assert float(out) == 16.0
    assert torch.isfinite(aux)
    ref_out, ref_aux = jax.jit(lambda a: ref_noisy_loop(
        lambda i, acc: acc + 1.0, 16, a, ref_modes()["fp_add"], k=2))(
            jnp.zeros((), jnp.float32))
    assert float(out) == float(ref_out)
    assert np.isfinite(float(ref_aux))


def test_card_carries_are_larger_than_the_l2():
    """On the card mem_ld and chase take 256 MiB buffers (the reference's
    64 MiB and 4 MiB would sit in the H100's 50 MB L2); on the CPU the
    reference's sizes."""
    assert ln.noise_size("mem_ld", "cuda") * ln.VEC * 4 == 256 << 20
    assert ln.noise_size("chase", "cuda") * 4 == 256 << 20
    assert ln.noise_size("mem_ld", "cpu") == ln.MEM_ROWS
    assert ln.noise_size("chase", "cpu") == ln.CHASE_LEN
    assert ln.noise_size("fp_add", "cuda") is None
    carry = ln.make_loop_modes()["chase"].init(
        torch.Generator().manual_seed(1), "cpu", 1 << 10)
    table, seen, idx = carry["table"], set(), int(carry["idx"])
    for _ in range(1 << 10):      # one cycle through every entry
        seen.add(idx)
        idx = int(table[idx])
    assert len(seen) == 1 << 10 and idx == int(carry["idx"])
