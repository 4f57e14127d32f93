"""Port parity for the dense attention family's serving: the SMOKE configs of
starcoder2-7b, granite-3-2b, olmo-1b and deepseek-67b, with the JAX
package's parameters carried by ``convert.to_lm_params``: prefill logits
through both attention branches, decode steps and greedy generation against
the JAX package, bf16, the port's own init, GELU's tanh form and the
registry."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jm  # noqa: E402
from repro import tuning as j_tuning  # noqa: E402
from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.models import attention as j_attention  # noqa: E402
from repro.train import serve_step as j_serve  # noqa: E402
from repro_torch import models as pm  # noqa: E402
from repro_torch import tuning  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.convert import to_lm_params  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as KF  # noqa: E402
from repro_torch.models import attention as p_attention  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402

DENSE = ("starcoder2-7b", "granite-3-2b", "olmo-1b", "deepseek-67b")
NOT_PORTED = ("qwen2-vl-7b", "qwen3-moe-30b-a3b", "arctic-480b", "seamless-m4t-medium",
              "hymba-1.5b")
STARCODER2_PARAMS = 7_172_858_880     # FULL, counted from the reference's init shapes
B, T = 2, 24
# fp32 logits against the reference, as tests/test_torch_lm.py holds RWKV6's:
# the same arithmetic up to the order of the fp32 sums in the matmuls, the
# norms and the softmax (XLA's and torch's)
LOGIT_RTOL, LOGIT_ATOL_REL = 1e-4, 1e-5
# bf16: every matmul, norm, softmax weight and activation is rounded to bf16
# at places where XLA and torch round differently, so the logits are held by
# their relative L2 distance, as RWKV6's are
BF16_REL_L2 = 3e-2
# the blockwise branch, forced at T 24 with 8 x 8 blocks (three q blocks,
# three kv blocks, each row's later kv blocks wholly masked)
SMALL_BLOCKWISE = dict(seq=16, q_block=8, kv_block=8)


def _cfgs(arch, dtype_j=jnp.float32, dtype_p=torch.float32):
    return (dataclasses.replace(j_get_arch(arch, smoke=True), dtype=dtype_j),
            dataclasses.replace(get_arch(arch, smoke=True), dtype=dtype_p))


def _params(cfg_j):
    tree = jax.tree.map(np.asarray, jm.init_params(cfg_j, jax.random.PRNGKey(0)))
    return tree, jax.tree.map(jnp.asarray, tree), to_lm_params(tree)


def _close(got, want, rtol=LOGIT_RTOL, atol_rel=LOGIT_ATOL_REL):
    got, want = np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rel * np.abs(want).max())


@pytest.fixture(scope="module", params=DENSE)
def fp32(request):
    cfg_j, cfg_p = _cfgs(request.param)
    tree, pj, pp = _params(cfg_j)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg_p.vocab, size=(B, T)).astype(np.int32)
    return cfg_j, cfg_p, tree, pj, pp, tokens


@pytest.fixture
def small_blockwise(monkeypatch):
    """Both packages' blockwise branch from SMALL_BLOCKWISE's length, with
    its blocks (test-local)."""
    sb = SMALL_BLOCKWISE
    monkeypatch.setattr(j_attention, "BLOCKWISE_MIN_SEQ", sb["seq"])
    monkeypatch.setattr(p_attention, "BLOCKWISE_MIN_SEQ", sb["seq"])
    j_tuning.set_tuning(q_block=sb["q_block"], kv_block=sb["kv_block"])
    tuning.set_tuning(q_block=sb["q_block"], kv_block=sb["kv_block"])
    yield
    j_tuning.reset()
    tuning.reset()


def _prefill(cfg_p, pp, tokens, **kw):
    return serve_step.build_prefill(cfg_p, **kw)(pp, {"tokens": torch.from_numpy(tokens).long()})


def test_prefill_matches_reference(fp32):
    cfg_j, cfg_p, _, pj, pp, tokens = fp32
    want, _ = jm.forward(pj, cfg_j, {"tokens": jnp.asarray(tokens)})
    got = _prefill(cfg_p, pp, tokens)
    assert got.shape == (B, T, cfg_p.padded_vocab) and got.dtype == torch.float32
    _close(got, want)
    assert torch.equal(got, _prefill(cfg_p, pp, tokens, attn_engine="torch"))
    assert KF.FLASH.launches == 0 and KF.FLASH_KVCHUNK.launches == 0


def test_blockwise_branch_matches_reference(fp32, small_blockwise):
    """The online-softmax branch in both packages, against each other and
    against the port's dense branch."""
    cfg_j, cfg_p, _, pj, pp, tokens = fp32
    want, _ = jm.forward(pj, cfg_j, {"tokens": jnp.asarray(tokens)})
    got = _prefill(cfg_p, pp, tokens)
    _close(got, want)
    p_attention.BLOCKWISE_MIN_SEQ = 8192   # undone by monkeypatch
    _close(got, _prefill(cfg_p, pp, tokens))


def test_decode_steps_match_reference(fp32):
    cfg_j, cfg_p, _, pj, pp, tokens = fp32
    cj = jm.init_cache(cfg_j, B, 32)
    cp = pm.init_cache(cfg_p, B, 32, device="cpu")
    step_j = jax.jit(j_serve.build_serve_step(cfg_j))
    step_p = serve_step.build_serve_step(cfg_p)
    for t in range(5):
        lj, cj = step_j(pj, cj, jnp.asarray(tokens[:, t]))
        lp, cp = step_p(pp, cp, torch.from_numpy(tokens[:, t]).long())
        _close(lp, lj)
    assert int(cp["pos"]) == int(cj["pos"]) == 5
    for key in ("k", "v"):
        assert cp[key].shape == cj[key].shape
        _close(cp[key], cj[key])


def test_greedy_generate_gives_reference_tokens(fp32):
    cfg_j, cfg_p, _, pj, pp, tokens = fp32
    prompt = tokens[:, :6]
    want = j_serve.generate(pj, cfg_j, jnp.asarray(prompt), steps=8, s_max=32)
    got = serve_step.generate(pp, cfg_p, torch.from_numpy(prompt).long(), steps=8, s_max=32)
    assert got.shape == (B, 14)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_last_position_matches_own_decode(fp32):
    _, cfg_p, _, _, pp, tokens = fp32
    tok = torch.from_numpy(tokens).long()
    pre = _prefill(cfg_p, pp, tokens)
    cache = pm.init_cache(cfg_p, B, 32, device="cpu")
    for t in range(T):
        logits, cache = pm.decode_step(pp, cfg_p, cache, tok[:, t])
    _close(pre[:, -1], logits)


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_forward_close_to_reference(arch):
    cfg_j, cfg_p = _cfgs(arch, jnp.bfloat16, torch.bfloat16)
    _, pj, pp = _params(cfg_j)
    tokens = np.random.default_rng(1).integers(0, cfg_p.vocab, size=(B, T)).astype(np.int32)
    want, _ = jm.forward(pj, cfg_j, {"tokens": jnp.asarray(tokens)})
    got, _ = pm.forward(pp, cfg_p, {"tokens": torch.from_numpy(tokens).long()})
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, dtype=np.float32)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < BF16_REL_L2


def test_to_lm_params_carries_the_dense_tree_bitwise(fp32):
    cfg_j, _, tree, _, pp, _ = fp32
    L = cfg_j.n_layers
    assert len(pp["layers"]) == L
    n = 0

    def walk(t, p, path):
        nonlocal n
        assert set(t) == set(p), path
        for key, val in t.items():
            if isinstance(val, dict):
                walk(val, p[key], path + (key,))
            else:
                want, got = np.asarray(val), p[key]
                assert tuple(got.shape) == want.shape and got.dtype == torch.float32, path
                np.testing.assert_array_equal(got.numpy(), want, err_msg=str(path))
                n += 1

    assert set(tree) == set(pp)
    walk({k: v for k, v in tree.items() if k != "layers"},
         {k: v for k, v in pp.items() if k != "layers"}, ())
    for i in range(L):
        walk(jax.tree.map(lambda a: a[i], tree["layers"]), pp["layers"][i], ("layers", i))
    assert n >= 3 + 6 * L


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_counts_and_places(arch):
    """The port's own init: the reference's leaf shapes, on the generator's
    device."""
    cfg_p, cfg_j = get_arch(arch, smoke=True), j_get_arch(arch, smoke=True)
    pp = pm.init_params(cfg_p, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.eval_shape(lambda: jm.init_params(cfg_j, jax.random.PRNGKey(0)))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for path, sd in flat:
        keys = [p.key for p in path]
        node = pp[keys[0]]
        if keys[0] == "layers":
            for i in range(cfg_p.n_layers):
                leaf = pp["layers"][i]
                for k in keys[1:]:
                    leaf = leaf[k]
                assert tuple(leaf.shape) == tuple(sd.shape[1:]), keys
                assert leaf.dtype == torch.bfloat16 and leaf.device.type == "cpu"
        else:
            for k in keys[1:]:
                node = node[k]
            assert tuple(node.shape) == tuple(sd.shape), keys


def test_starcoder2_full_parameter_count():
    """The count chip_smoke.py asserts on the card, from the reference's
    init shapes; the port's SMOKE init holds the reference's count."""
    shapes = jax.eval_shape(lambda: jm.init_params(j_get_arch("starcoder2-7b"),
                                                   jax.random.PRNGKey(0)))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == STARCODER2_PARAMS
    cfg_p = get_arch("starcoder2-7b", smoke=True)
    pp = pm.init_params(cfg_p, torch.Generator().manual_seed(0), device="cpu")
    smoke = jax.eval_shape(lambda: jm.init_params(j_get_arch("starcoder2-7b", smoke=True),
                                                  jax.random.PRNGKey(0)))
    n_port = sum(t.numel() for t in jax.tree.leaves(pp))
    assert n_port == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(smoke))


def test_gelu_is_the_tanh_form(rng):
    """jax.nn.gelu defaults to approximate=True; torch's F.gelu to the exact
    erf form, which differs by up to ~5e-4 on [-6, 6]."""
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    got = layers._act(torch.from_numpy(x), "gelu").numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - got).max() > 1e-4
    np.testing.assert_allclose(layers._act(torch.from_numpy(x), "silu").numpy(),
                               np.asarray(jax.nn.silu(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_registry_runs_the_dense_family():
    assert ARCH_IDS == J_ARCH_IDS
    for arch in DENSE:
        for smoke in (False, True):
            cfg, jcfg = get_arch(arch, smoke=smoke), j_get_arch(arch, smoke=smoke)
            assert cfg.dtype == torch.bfloat16 and cfg.family == "dense"
            for f in dataclasses.fields(jcfg):
                if f.name != "dtype":
                    assert getattr(cfg, f.name) == getattr(jcfg, f.name), (arch, f.name)
    for arch in NOT_PORTED:
        with pytest.raises(NotImplementedError, match=f"{arch!r} is not yet ported"):
            get_arch(arch)
    assert set(DENSE) | set(NOT_PORTED) | {"rwkv6-7b"} == set(ARCH_IDS)


@pytest.mark.parametrize("change,what", [
    (dict(family="moe"), "moe family"), (dict(family="vlm"), "vlm family"),
    (dict(family="hybrid"), "hybrid family"), (dict(family="audio"), "audio family"),
    (dict(qk_norm=True), "qk-norm"), (dict(mrope_sections=(2, 3, 3)), "M-RoPE")])
def test_unported_families_raise(change, what):
    cfg = dataclasses.replace(get_arch("granite-3-2b", smoke=True), **change)
    with pytest.raises(NotImplementedError, match=f"{what}.*not yet ported"):
        pm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        pm.init_cache(cfg, 1, 8, device="cpu")
