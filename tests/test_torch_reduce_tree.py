"""K2's fold trees, emulated (``repro_torch.core.reduce``: ``partials_tree``,
``fold_tree``, ``reduce_tree`` and their compensated instances), on the CPU.

The card tests hold the kernels bitwise to these emulations; here they are
held to the JAX package's ``target_sum`` (its jnp engine, and its pallas
engine in interpret mode), to the fp64 oracle on random and adversarial
fields, batched rows to the single emulation, and the cancellation
fixtures to the trees they were built for."""

import math
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import Field as JField  # noqa: E402
from repro.core import LoweringPlan as JPlan  # noqa: E402
from repro.core import TargetConfig as JTC  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import target_max as j_max  # noqa: E402
from repro.core import target_sum as j_sum  # noqa: E402
from repro_torch import _cuda  # noqa: E402
from repro_torch.core import BatchedField, Field, TargetConfig  # noqa: E402
from repro_torch.core import reduce as R  # noqa: E402

SUM_RTOL, SUM_ATOL = 1e-5, 1e-5   # the sum parity tests' (tests/test_torch_core.py)
ORACLE_RTOL = 2.5e-7   # |sum - fp64 sum| <= ORACLE_RTOL * sum|x| + 1e-6 (tests/test_dtype.py)
CHUNK = R.CHUNK
TAILS = [1, 100, CHUNK - 1, CHUNK + 3, 3 * CHUNK]
J_ACC64 = jplan.DtypePolicy(accumulate="float64")
JAX_ENGINES = {"jnp": lambda pol: JTC("jnp", plan_policy=JPlan("jnp", dtypes=pol)),
               "pallas": lambda pol: JTC("pallas", plan_policy=JPlan("pallas", vvl=128,
                                                                     interpret=True, dtypes=pol))}


def _oracle_ratio(got, terms):
    """max over components of |got - fp64 sum| / (ORACLE_RTOL sum|x| + 1e-6)."""
    t = terms.double()
    bound = ORACLE_RTOL * t.abs().sum(dim=-1) + 1e-6
    return float(((got.double() - t.sum(dim=-1)).abs() / bound).max())


def _close_sum(got, terms):
    t = terms.double()
    err = (got.double() - t.sum(dim=-1)).abs()
    assert bool((err <= SUM_RTOL * t.abs().sum(dim=-1)).all()), err.max()


def _field(rng, ncomp, nsites, scale=1.0):
    return torch.from_numpy((rng.normal(size=(ncomp, nsites)) * scale).astype(np.float32))


# -- against the JAX package ----------------------------------------------------------

@pytest.mark.parametrize("compensated", [False, True], ids=["plain", "compensated"])
@pytest.mark.parametrize("ncomp,lat", [(24, (8, 8, 8, 16)), (19, (16, 16, 20))],
                         ids=["milc24", "ludwig19"])
@pytest.mark.parametrize("engine", list(JAX_ENGINES))
def test_tree_matches_jax_target_sum(engine, ncomp, lat, compensated, rng):
    """The emulated K2 (plain: two chunks of 4096 at 24 components, a tail
    chunk at 19; compensated) against the JAX package's target_sum on the
    same seeded fields, within the sum parity tolerance (rtol 1e-5, atol
    1e-5)."""
    x = rng.normal(size=(ncomp,) + lat).astype(np.float32)
    pol = J_ACC64 if compensated else None
    want = np.asarray(j_sum(JField.from_numpy("x", x, lat), JAX_ENGINES[engine](pol)))
    got = R.reduce_tree(torch.from_numpy(x.reshape(ncomp, -1)), compensated=compensated)
    np.testing.assert_allclose(got.numpy(), want, rtol=SUM_RTOL, atol=SUM_ATOL)


# -- against the fp64 oracle ------------------------------------------------------------

@pytest.mark.parametrize("nsites", TAILS)
def test_tree_against_the_oracle(nsites, rng):
    """Random fields at sizes with tails: the plain tree within SUM_RTOL x
    sum|terms| of the fp64 sum, the compensated one within the oracle
    bound; max exact; the same bits on a second run."""
    x = _field(rng, 24, nsites, 1e3)
    plain = R.reduce_tree(x)
    _close_sum(plain, x)
    assert _oracle_ratio(R.reduce_tree(x, compensated=True), x) <= 1.0
    assert torch.equal(R.reduce_tree(x, "max"), x.amax(dim=1))
    assert torch.equal(plain, R.reduce_tree(x.clone()))


def test_tree_adversarial_fields():
    """The adversarial fixtures of the mixed-precision tests (cancelling
    pairs, a large run then a tiny one), laid over 1, 100, chunk - 1 and
    chunk + 3 sites: the compensated tree within the oracle bound, the
    plain one within SUM_RTOL."""
    pats = [np.array([1.0, 1e8, 1.0, -1e8], np.float32),
            np.array([1e7, 0.125, -1e7, 0.125], np.float32),
            np.concatenate([np.full(64, 3e7, np.float32), np.full(64, -3e7, np.float32),
                            np.full(64, 2.0 ** -12, np.float32)])]
    for n in TAILS[:4]:
        x = torch.from_numpy(np.stack([np.resize(p, n) for p in pats]))
        assert _oracle_ratio(R.reduce_tree(x, compensated=True), x) <= 1.0
        _close_sum(R.reduce_tree(x), x)


@pytest.mark.parametrize("nrows,ncomp", [(1, 24), (672, 24), (673, 24), (65536, 24),
                                         (131072, 19), (2048, 19), (3, 1100 // 2)])
def test_fold_tree_against_the_oracle(nrows, ncomp, rng):
    """Pass 2 alone on tables of the fused kernels' shapes (65,536 x 24 at
    milc_small, 131,072 x 19 at ludwig_small), at the one-launch limit (16
    R2 rows: 672 at 24 components) and past it: plain within SUM_RTOL, the
    compensated fold of (hi, lo) pairs within the oracle bound of hi + lo."""
    p = _field(rng, nrows, ncomp)
    _close_sum(R.fold_tree(p), p.T)
    pairs = torch.stack([p, p * 2.0 ** -30], dim=-1)
    assert _oracle_ratio(R.fold_tree(pairs, compensated=True),
                         pairs.permute(1, 0, 2).reshape(ncomp, -1)) <= 1.0
    assert torch.equal(R.fold_tree(p, "max"), p.amax(dim=0))


def test_fold_tree_refuses_too_many_components():
    with pytest.raises(ValueError, match="at most"):
        R.fold_tree(torch.zeros((4, 1025)))


# -- the cancellation fixtures --------------------------------------------------------

@pytest.mark.parametrize("nchunks", [1, 3])
def test_cancel_field_splits_the_trees(nchunks):
    """cancel_field: the emulated plain K2 loses every filler (its sum is 0)
    and falls outside the oracle bound (3.52 x it); the compensated K2
    falls inside it."""
    x = R.cancel_field(3, nchunks * CHUNK)
    plain = R.reduce_tree(x)
    assert torch.equal(plain, torch.zeros(3))
    assert _oracle_ratio(plain, x) > 3.5
    assert _oracle_ratio(R.reduce_tree(x, compensated=True), x) <= 1.0
    with pytest.raises(ValueError, match="multiple"):
        R.cancel_field(3, CHUNK + 4)


def test_small_cancellation_fixture():
    """The card test's small fixture (3 x 256 sites, filler 0.1875, +-1e8 at
    virtual threads 0 and 32): the plain tree loses the filler (2.625 of
    it), the compensated tree keeps it within the oracle bound."""
    x = np.zeros((3, 256), np.float32)
    x[:, [1, 2, 4, 8, 16, 32, 64]] = x[:, [129, 130, 132, 136, 144, 160, 192]] = 0.1875
    x[:, 0], x[:, 128] = 1.0e8, -1.0e8
    t = torch.from_numpy(x)
    assert float((R.reduce_tree(t).double() - 2.625).abs().max()) > 0.1
    assert _oracle_ratio(R.reduce_tree(t, compensated=True), t) <= 1.0


@pytest.mark.parametrize("nrows,ncomp", [(65536, 24), (2048, 24), (131072, 19), (7, 24)])
def test_fold_pairs_splits_the_folds(nrows, ncomp):
    """fold_pairs: the emulated compensated fold within the oracle bound of
    hi + lo, the plain fold of the his alone (lo dropped) outside it."""
    pairs = R.fold_pairs(nrows, ncomp)
    terms = pairs.permute(1, 0, 2).reshape(ncomp, -1)
    assert _oracle_ratio(R.fold_tree(pairs, compensated=True), terms) <= 1.0
    assert _oracle_ratio(R.fold_tree(pairs[..., 0].contiguous()), terms) > 1.0


# -- batched rows, the partition ------------------------------------------------------

@pytest.mark.parametrize("compensated", [False, True], ids=["plain", "compensated"])
def test_batched_rows_bitwise_the_single_tree(compensated, rng):
    """Slot b of a batched emulation is bitwise the single emulation of slot
    b (pass 1 and pass 2, and pass 2 alone on a (batch, nrows, ncomp)
    table)."""
    x = torch.from_numpy(rng.normal(size=(3, 24, CHUNK + 100)).astype(np.float32))
    rows = R.reduce_tree(x, compensated=compensated)
    parts = torch.from_numpy(rng.normal(size=(3, 2000, 24)).astype(np.float32))
    if compensated:
        parts = torch.stack([parts, parts * 2.0 ** -25], dim=-1)
    folded = R.fold_tree(parts, compensated=compensated)
    for b in range(3):
        assert torch.equal(rows[b], R.reduce_tree(x[b], compensated=compensated))
        assert torch.equal(folded[b], R.fold_tree(parts[b], compensated=compensated))
    assert torch.equal(R.reduce_tree(x, "max")[1], x[1].amax(dim=1))


@pytest.mark.parametrize("nsites", TAILS)
def test_partial_table_matches_the_chunk(nsites):
    """The partial table core/reduce.py sizes (partial_rows) has one row per
    RT_REDUCE_CHUNK sites of csrc/reduce.cu, the constant rt_reduce_chunk()
    returns, and the emulated pass 1 writes that many rows."""
    src = (_cuda.CSRC / "reduce.cu").read_text()
    chunk = int(re.search(r"^#define RT_REDUCE_CHUNK (\d+)", src, re.M).group(1))
    assert re.search(r"int rt_reduce_chunk\(void\) \{ return RT_REDUCE_CHUNK; \}", src)
    assert R.CHUNK == chunk
    assert R.partial_rows(nsites) == math.ceil(nsites / chunk)
    x = torch.ones((2, nsites))
    assert R.partials_tree(x).shape == (R.partial_rows(nsites), 2)
    assert R.partials_tree(x, compensated=True).shape == (R.partial_rows(nsites), 2, 2)
    assert torch.equal(R.reduce_tree(x), torch.full((2,), float(nsites)))


# -- max propagates NaN ------------------------------------------------------------------
#
# The reference's max is jnp.max, which propagates NaN; K2 combined max with
# fmaxf, which drops it (csrc/common.cuh now uses max.NaN.f32).  A NaN's
# payload is not pinned: only where the NaNs are, and every other value's bits.

NAN_LAT = (4, 4, 8)
TORCH_CPU = TargetConfig("torch", device="cpu")


def _nan_field(all_nan_comp=None):
    """(2, 128) x[c, s] = (128 c + s) / 7 with x[0, 5] NaN (and component
    ``all_nan_comp`` NaN at every site), as (2, 4, 4, 8) fp32."""
    x = (np.arange(2 * 128, dtype=np.float32).reshape(2, 128) / np.float32(7.0))
    x[0, 5] = np.nan
    if all_nan_comp is not None:
        x[all_nan_comp] = np.nan
    return x.reshape((2,) + NAN_LAT)


def _same_nan_bits(got, want):
    """NaN exactly where want has NaN, every other value bitwise."""
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), (got, want)
    assert np.array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32)), (got, want)


@pytest.mark.parametrize("engine", list(JAX_ENGINES))
def test_max_propagates_nan_as_the_reference(engine):
    """The reference's target_max on (4, 4, 8), x[c, s] = (128 c + s) / 7,
    x[0, 5] = NaN gives [nan, 36.42857] on its jnp and pallas (interpret)
    engines; the torch engine's target_max and K2's tree emulation (what the
    card's K2 is held to bitwise) give the same: NaN in component 0,
    component 1 bitwise."""
    x = _nan_field()
    want = np.asarray(j_max(JField.from_numpy("x", x, NAN_LAT), JAX_ENGINES[engine](None)))
    assert np.isnan(want[0]) and want[1] == np.float32(255 / 7)
    np.testing.assert_allclose(want[1], 36.42857, rtol=1e-6)
    _same_nan_bits(R.target_max(Field.from_numpy("x", x, NAN_LAT), TORCH_CPU).numpy(), want)
    _same_nan_bits(R.reduce_tree(torch.from_numpy(x.reshape(2, -1)), "max").numpy(), want)


@pytest.mark.parametrize("engine", list(JAX_ENGINES))
def test_max_of_an_all_nan_component(engine):
    """A component that is NaN at every site gives NaN (fmaxf gave -inf),
    the other component keeps the reference's bits; on the reference, the
    torch engine and the tree."""
    x = _nan_field(all_nan_comp=1)
    want = np.asarray(j_max(JField.from_numpy("x", x, NAN_LAT), JAX_ENGINES[engine](None)))
    assert np.isnan(want).all()
    _same_nan_bits(R.target_max(Field.from_numpy("x", x, NAN_LAT), TORCH_CPU).numpy(), want)
    _same_nan_bits(R.reduce_tree(torch.from_numpy(x.reshape(2, -1)), "max").numpy(), want)
    y = _nan_field()
    y[0] = np.nan
    want = np.asarray(j_max(JField.from_numpy("y", y, NAN_LAT), JAX_ENGINES[engine](None)))
    assert np.isnan(want[0]) and want[1] == np.float32(255 / 7)
    _same_nan_bits(R.reduce_tree(torch.from_numpy(y.reshape(2, -1)), "max").numpy(), want)


def test_batched_max_propagates_nan():
    """reduce_sites_batched(op="max") and a BatchedField's target_max: each
    row as the reference's single max of its slot (NaN where it has NaN,
    the rest bitwise), and bitwise the tree emulation's batched rows."""
    slots = [_nan_field(), _nan_field(all_nan_comp=0), np.ones((2,) + NAN_LAT, np.float32)]
    slots[2][1, 1, 1, 1] = np.nan
    want = np.stack([np.asarray(j_max(JField.from_numpy("x", a, NAN_LAT), JTC("jnp")))
                     for a in slots])
    assert np.isnan(want[2, 1]) and want[2, 0] == 1.0
    stack = torch.from_numpy(np.stack([a.reshape(2, -1) for a in slots]))
    _same_nan_bits(R.reduce_sites_batched(stack, "max").numpy(), want)
    bf = BatchedField.from_canonical("x", stack, NAN_LAT)
    _same_nan_bits(R.target_max(bf, TORCH_CPU).numpy(), want)
    _same_nan_bits(R.reduce_tree(stack, "max").numpy(), want)
