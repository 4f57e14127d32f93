"""Port parity for RWKV6 serving: the SMOKE config's prefill, decode steps
and greedy generation against the JAX package on the same parameters
(carried with ``convert.to_lm_params``), the port's prefill against its own
decode, a bf16 forward, the parameter carry itself and the registry."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.train import serve_step as j_serve  # noqa: E402
from repro_torch import models as pm  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.convert import to_lm_params  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel as K10  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402

B, T = 2, 24
# fp32 logits against the reference: the same arithmetic in the same order
# up to the fp32 sums of the matmuls, the norms and the chunked WKV, taken
# in another order by XLA and by torch.  The logits are O(1); the largest
# difference of the prefill was 1.6e-5 at max|logit| 3.8, 4e-6 of it.
LOGIT_RTOL, LOGIT_ATOL_REL = 1e-4, 1e-5
# bf16: every matmul output, norm output and the WKV output is rounded to
# bf16 (8 bits of mantissa, 4e-3 relative) in each of the 2 layers, at places
# where XLA and torch round differently, so the logits are held by their
# relative L2 distance (1.45e-2 measured).
BF16_REL_L2 = 3e-2


def _cfgs(dtype_j=jnp.float32, dtype_p=torch.float32):
    return (dataclasses.replace(j_get_arch("rwkv6-7b", smoke=True), dtype=dtype_j),
            dataclasses.replace(get_arch("rwkv6-7b", smoke=True), dtype=dtype_p))


def _params(cfg_j, rng):
    """The reference's init with a random bonus u (init sets it to zero, so
    the WKV's bonus term would go untested), as numpy and as both packages'
    parameters."""
    tree = jax.tree.map(np.asarray, jm.init_params(cfg_j, jax.random.PRNGKey(0)))
    bonus = tree["layers"]["rwkv"]["tmix"]["bonus"]
    tree["layers"]["rwkv"]["tmix"]["bonus"] = (0.5 * rng.normal(size=bonus.shape)).astype(
        bonus.dtype)
    return tree, jax.tree.map(jnp.asarray, tree), to_lm_params(tree)


def _close(got, want, rtol=LOGIT_RTOL, atol_rel=LOGIT_ATOL_REL):
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max())


@pytest.fixture(scope="module")
def fp32():
    rng = np.random.default_rng(0)
    cfg_j, cfg_p = _cfgs()
    _, pj, pp = _params(cfg_j, rng)
    tokens = rng.integers(0, cfg_p.vocab, size=(B, T)).astype(np.int32)
    return cfg_j, cfg_p, pj, pp, tokens


def test_prefill_matches_reference(fp32):
    cfg_j, cfg_p, pj, pp, tokens = fp32
    want, _ = jm.forward(pj, cfg_j, {"tokens": jnp.asarray(tokens)})
    got = serve_step.build_prefill(cfg_p)(pp, {"tokens": torch.from_numpy(tokens).long()})
    assert got.shape == (B, T, cfg_p.padded_vocab) and got.dtype == torch.float32
    _close(got, want)
    # the reference's pallas engine (interpret mode) gives the same logits
    want_pl, _ = jm.forward(pj, cfg_j, {"tokens": jnp.asarray(tokens)}, wkv_engine="pallas")
    _close(got, want_pl)
    assert K10.WKV.launches == 0


def test_decode_steps_match_reference(fp32):
    cfg_j, cfg_p, pj, pp, tokens = fp32
    cj = jm.init_cache(cfg_j, B, 32)
    cp = pm.init_cache(cfg_p, B, 32, device="cpu")
    step_j = jax.jit(j_serve.build_serve_step(cfg_j))
    step_p = serve_step.build_serve_step(cfg_p)
    for t in range(5):
        lj, cj = step_j(pj, cj, jnp.asarray(tokens[:, t]))
        lp, cp = step_p(pp, cp, torch.from_numpy(tokens[:, t]).long())
        _close(lp, lj)
    assert int(cp["pos"]) == int(cj["pos"]) == 5
    for key in ("att_xprev", "ffn_xprev", "wkv"):
        assert cp[key].shape == cj[key].shape
        _close(cp[key], cj[key])


def test_greedy_generate_gives_reference_tokens(fp32):
    cfg_j, cfg_p, pj, pp, tokens = fp32
    prompt = tokens[:, :6]
    want = j_serve.generate(pj, cfg_j, jnp.asarray(prompt), steps=8, s_max=32)
    got = serve_step.generate(pp, cfg_p, torch.from_numpy(prompt).long(), steps=8, s_max=32)
    assert got.shape == (B, 14)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_generate_is_reproducible(fp32):
    _, cfg_p, _, pp, tokens = fp32
    prompt = torch.from_numpy(tokens[:, :4]).long()
    a = serve_step.generate(pp, cfg_p, prompt, steps=4, s_max=16, temperature=0.8)
    b = serve_step.generate(pp, cfg_p, prompt, steps=4, s_max=16, temperature=0.8)
    assert torch.equal(a, b) and int(a.max()) < cfg_p.padded_vocab


def test_prefill_last_position_matches_own_decode(fp32):
    """The chunked prefill and the token-by-token recurrence are one
    function: the prefill's logits at the last prompt position equal the
    decode's after the same prompt."""
    _, cfg_p, _, pp, tokens = fp32
    tok = torch.from_numpy(tokens).long()
    pre = serve_step.build_prefill(cfg_p)(pp, {"tokens": tok})
    cache = pm.init_cache(cfg_p, B, 32, device="cpu")
    for t in range(T):
        logits, cache = pm.decode_step(pp, cfg_p, cache, tok[:, t])
    _close(pre[:, -1], logits)


def test_bf16_forward_close_to_reference():
    rng = np.random.default_rng(1)
    cfg_j, cfg_p = _cfgs(jnp.bfloat16, torch.bfloat16)
    _, pj, pp = _params(cfg_j, rng)
    tokens = rng.integers(0, cfg_p.vocab, size=(B, T)).astype(np.int32)
    want, _ = jm.forward(pj, cfg_j, {"tokens": jnp.asarray(tokens)})
    got, _ = pm.forward(pp, cfg_p, {"tokens": torch.from_numpy(tokens).long()})
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, dtype=np.float32)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < BF16_REL_L2


def test_to_lm_params_carries_every_leaf_bitwise(rng):
    cfg_j, _ = _cfgs(jnp.bfloat16)
    tree, _, pp = _params(cfg_j, rng)
    L = cfg_j.n_layers
    assert len(pp["layers"]) == L
    leaves = []

    def walk(t, p, path):
        for key, val in t.items():
            if isinstance(val, dict):
                walk(val, p[key], path + (key,))
            else:
                leaves.append((path + (key,), val, p[key]))

    walk({k: v for k, v in tree.items() if k != "layers"}, pp, ())
    for i in range(L):
        walk(jax.tree.map(lambda a: a[i], tree["layers"]), pp["layers"][i], ("layers", i))
    dtypes = set()
    for path, want, got in leaves:
        want = np.asarray(want)
        dtypes.add(want.dtype.name)
        assert tuple(got.shape) == want.shape, path
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                          want.view(np.uint16), err_msg=str(path))
        else:
            assert got.dtype == torch.float32, path
            np.testing.assert_array_equal(got.numpy(), want, err_msg=str(path))
    assert dtypes == {"bfloat16", "float32"}


def test_registry_ports_rwkv6_only():
    assert ARCH_IDS == J_ARCH_IDS and len(ARCH_IDS) == 10
    full = get_arch("rwkv6-7b")
    jfull = j_get_arch("rwkv6-7b")
    assert full.dtype == torch.bfloat16
    for f in dataclasses.fields(jfull):
        if f.name != "dtype":
            assert getattr(full, f.name) == getattr(jfull, f.name), f.name
    assert full.param_count() == jfull.param_count()
    assert (full.head_dim, full.padded_vocab) == (64, 65536)
    for arch in ARCH_IDS:
        if arch in ("rwkv6-7b", "starcoder2-7b", "granite-3-2b", "olmo-1b", "deepseek-67b"):
            continue   # ported (the dense family: tests/test_torch_dense.py)
        with pytest.raises(NotImplementedError, match=f"{arch!r} is not yet ported"):
            get_arch(arch)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_init_params_counts_and_places(rng):
    """The port's own init: the reference's leaf shapes and dtypes, on the
    generator's device; a non-attention-free config is refused."""
    cfg_p = get_arch("rwkv6-7b", smoke=True)
    cfg_j = j_get_arch("rwkv6-7b", smoke=True)
    pp = pm.init_params(cfg_p, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.eval_shape(lambda: jm.init_params(cfg_j, jax.random.PRNGKey(0)))
    n_ref = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    n_port = sum(t.numel() for t in _tensors(pp))
    assert n_port == n_ref
    assert all(t.device.type == "cpu" for t in _tensors(pp))
    with pytest.raises(ValueError, match="generator"):
        pm.init_params(cfg_p, torch.Generator().manual_seed(0), device="meta")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        pm.init_params(dataclasses.replace(cfg_p, attn_free=False),
                       torch.Generator().manual_seed(0), device="cpu")


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree
