"""Port parity for the RWKV6 WKV op: the port's "torch" (chunked) and
"scan" engines against the JAX package's "jnp", "scan" and "pallas"
(interpret mode) engines on the same numpy inputs, the decode step, the
chunk choice, K10's CPU wrapper and the refusals of the "cuda" engine."""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rwkv6_scan import rwkv6 as j_rwkv6  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_decode_step as j_decode  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as K10  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops, ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6, rwkv6_decode_step  # noqa: E402

# The port's chunked form against the reference's.  The reference holds its
# own pallas and jnp engines to a flat 3e-5, but a torch chunk_body against
# the jnp engine misses that at the larger shapes: 1.9e-4 at max|o| = 31.5
# for (2,4,256,64,64) with chunk 64, the fp32 sums over C * dk terms being
# taken in another order.  The error scales with the output's size (below
# 6e-6 x max|ref| in every case), so the absolute tolerance does too.
RTOL, ATOL_REL = 1e-5, 2e-5
# the reference's own tolerance between its chunked form and the scan oracle
# (tests/test_kernels_rwkv.py), whose sums differ in order over the sequence
SCAN_TOL = 1e-3


def _problem(rng, B, H, T, dk, dv, strong_decay=True):
    """tests/test_kernels_rwkv.py's inputs."""
    r = rng.normal(size=(B, H, T, dk)).astype(np.float32)
    k = (0.3 * rng.normal(size=(B, H, T, dk))).astype(np.float32)
    v = rng.normal(size=(B, H, T, dv)).astype(np.float32)
    scale = 1.0 if strong_decay else -2.0
    w = np.exp(-np.exp(scale + rng.normal(size=(B, H, T, dk)))).astype(np.float32)
    u = (0.5 * rng.normal(size=(H, dk))).astype(np.float32)
    s0 = (0.1 * rng.normal(size=(B, H, dk, dv))).astype(np.float32)
    return r, k, v, w, u, s0


@functools.lru_cache(maxsize=None)
def _scan_case(shape):
    """The inputs of a shape (seed 0) with the reference's scan oracle on
    them, shared by the chunk sizes."""
    prob = _problem(np.random.default_rng(0), *shape)
    return prob, j_rwkv6(*prob, engine="scan")


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _close(got, want, rtol=RTOL, atol_rel=ATOL_REL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max())


@pytest.mark.parametrize("shape", [(1, 1, 32, 8, 8), (2, 3, 128, 16, 24),
                                   (1, 2, 64, 32, 32)], ids=str)
@pytest.mark.parametrize("chunk", [16, 32])
def test_engines_match_reference(shape, chunk):
    prob, (o_js, s_js) = _scan_case(shape)
    o_jnp, s_jnp = j_rwkv6(*prob, engine="jnp", chunk=chunk)
    o_pl, s_pl = j_rwkv6(*prob, engine="pallas", chunk=chunk)
    o, s = rwkv6(*_t(*prob), engine="torch", chunk=chunk)
    assert o.dtype == torch.float32 and s.dtype == torch.float32
    for want_o, want_s in ((o_jnp, s_jnp), (o_pl, s_pl)):
        _close(o, want_o)
        _close(s, want_s)
    o_sc, s_sc = rwkv6(*_t(*prob), engine="scan")
    _close(o_sc, o_js)
    _close(s_sc, s_js)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_js), rtol=SCAN_TOL, atol=SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_js), rtol=SCAN_TOL, atol=SCAN_TOL)


def test_full_head_chunk_matches_reference(rng):
    """rwkv6-7b's head size and chunk: (2, 4, 256, 64, 64), chunk 64."""
    prob = _problem(rng, 2, 4, 256, 64, 64)
    o_jnp, s_jnp = j_rwkv6(*prob, engine="jnp", chunk=64)
    o, s = rwkv6(*_t(*prob), engine="torch", chunk=64)
    _close(o, o_jnp)
    _close(s, s_jnp)


def test_strong_decay_no_overflow(rng):
    """w near 0 (aggressive forgetting): finite, within the reference's 1e-4
    of its scan oracle."""
    r, k, v, w, u, s0 = _problem(rng, 1, 1, 64, 8, 8)
    w = np.full_like(w, 1e-6)
    o_ref, _ = j_rwkv6(r, k, v, w, u, s0, engine="scan")
    o, _ = rwkv6(*_t(r, k, v, w, u, s0), engine="torch", chunk=32)
    assert torch.isfinite(o).all()
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=1e-4, atol=1e-4)


def test_decode_continues_scan(rng):
    B, H, T, dk, dv = 2, 2, 16, 8, 8
    r, k, v, w, u, s0 = _problem(rng, B, H, T, dk, dv)
    o_ref, s_ref = j_rwkv6(r, k, v, w, u, s0, engine="scan")
    s, sj = torch.from_numpy(s0), jnp.asarray(s0)
    outs = []
    for t in range(T):
        xs = [x[:, :, t] for x in (r, k, v, w)]
        o1, s = rwkv6_decode_step(*_t(*xs), torch.from_numpy(u), s)
        oj, sj = j_decode(*xs, jnp.asarray(u), sj)
        _close(o1, oj)
        outs.append(o1.numpy())
    _close(s, sj)
    # the reference's own tolerance for decode against its scan
    np.testing.assert_allclose(np.stack(outs, 2), np.asarray(o_ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("T,want", [(100, 50), (97, 1), (64, 64), (24, 24)])
def test_chunk_choice(T, want, rng):
    """min(chunk, T), then down until it divides T, as the reference picks."""
    assert ops.pick_chunk(64, T) == want
    prob = _problem(rng, 1, 2, T, 16, 16)
    o, s = rwkv6(*_t(*prob), engine="torch")
    o_c, s_c = ref.rwkv6_chunked(*_t(*prob), chunk=want)
    assert torch.equal(o, o_c) and torch.equal(s, s_c)
    if T == 100:
        o_j, s_j = j_rwkv6(*prob, engine="jnp")
        _close(o, o_j)
        _close(s, s_j)


def test_auto_engine_and_dtype_on_cpu(rng):
    prob = _t(*_problem(rng, 1, 2, 32, 8, 8))
    o, s = rwkv6(*prob)
    o_t, s_t = rwkv6(*prob, engine="torch")
    assert torch.equal(o, o_t) and torch.equal(s, s_t)
    ob, _ = rwkv6(*(x.to(torch.bfloat16) for x in prob[:4]), prob[4], prob[5])
    assert ob.dtype == torch.bfloat16


def test_kernel_wrapper_takes_the_plain_version_on_cpu(rng):
    B, H, T, dk, dv = 2, 3, 48, 16, 8
    r, k, v, w, u, s0 = _t(*_problem(rng, B, H, T, dk, dv))
    BH = B * H
    ub = u.expand(B, H, dk).reshape(BH, dk)
    o, s = K10.rwkv6_cuda(r.reshape(BH, T, dk), k.reshape(BH, T, dk), v.reshape(BH, T, dv),
                          w.reshape(BH, T, dk), ub, s0.reshape(BH, dk, dv), chunk=16)
    o_c, s_c = ref.rwkv6_chunked(r, k, v, w, u, s0, chunk=16)
    assert torch.equal(o, o_c.reshape(BH, T, dv)) and torch.equal(s, s_c.reshape(BH, dk, dv))
    assert K10.WKV.launches == 0


def test_refusals(rng):
    r, k, v, w, u, s0 = _t(*_problem(rng, 1, 2, 32, 8, 8))
    with pytest.raises(ValueError, match="CUDA device"):
        rwkv6(r, k, v, w, u, s0, engine="cuda")
    with pytest.raises(ValueError, match="unknown engine"):
        rwkv6(r, k, v, w, u, s0, engine="pallas")
    # the limits are checked before any device check
    r2, k2, v2, w2, u2, s02 = _t(*_problem(rng, 1, 2, 128, 8, 8))
    with pytest.raises(ValueError, match="chunk from 1 to 64, got 128"):
        rwkv6(r2, k2, v2, w2, u2, s02, engine="cuda", chunk=128)
    r3, k3, v3, w3, u3, s03 = _t(*_problem(rng, 1, 1, 16, 80, 8))
    with pytest.raises(ValueError, match="dk from 1 to 64, got 80"):
        rwkv6(r3, k3, v3, w3, u3, s03, engine="cuda")
    r4, k4, v4, w4, u4, s04 = _t(*_problem(rng, 1, 1, 16, 8, 96))
    with pytest.raises(ValueError, match="dv from 1 to 64, got 96"):
        rwkv6(r4, k4, v4, w4, u4, s04, engine="cuda")
    with pytest.raises(ValueError, match="dv from 1 to 64, got 96"):
        K10.rwkv6_cuda(r4[0], k4[0], v4[0], w4[0], u4, s04[0], chunk=16)
    with pytest.raises(ValueError, match="must divide"):
        K10.rwkv6_cuda(r[0], k[0], v[0], w[0], u, s0[0], chunk=24)
