"""Ops of the PyTorch port against the JAX package, on the CPU in fp32.

The same numpy inputs go through both; the port's plain attention versions
are held to the JAX Pallas kernels run in interpret mode (tolerance 2e-5, as
the JAX kernel tests use).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu.ops import attention as jattn
from paligemma_tpu.ops import norms as jnorms
from paligemma_tpu.ops import rope as jrope
from paligemma_tpu.ops.pallas_attention import decode_attention as j_decode
from paligemma_tpu.ops.pallas_attention import flash_attention as j_flash
from paligemma_tpu_torch.ops import attention as tattn
from paligemma_tpu_torch.ops import cuda_attention as ca
from paligemma_tpu_torch.ops.kernels import KERNELS, PLAIN
from paligemma_tpu_torch.ops import norms as tnorms
from paligemma_tpu_torch.ops import rope as trope
from paligemma_tpu_torch.ops.sampling import greedy

TOL = 2e-5


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol)


def test_rms_norm_and_layer_norm_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 32).astype(np.float32)
    w = rng.randn(32).astype(np.float32) * 0.1
    b = rng.randn(32).astype(np.float32) * 0.1
    _close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w)), 1e-6)
    _close(tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)),
           jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)), 1e-6)


def test_rope_matches_jax_including_position_clamp():
    rng = np.random.RandomState(1)
    pos = np.array([[0, 3, 17, 511, 600, 9000]], np.int32)  # past max_position clamps
    cos_t, sin_t = trope.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0, 512)
    cos_j, sin_j = jrope.rope_cos_sin(jnp.asarray(pos), 16, 10000.0, 512)
    _close(cos_t, cos_j, 1e-5)
    _close(sin_t, sin_j, 1e-5)
    x = rng.randn(1, 6, 3, 16).astype(np.float32)
    _close(trope.apply_rope(torch.from_numpy(x), cos_t, sin_t),
           jrope.apply_rope(jnp.asarray(x), cos_j, sin_j), 1e-5)


def test_mha_and_gqa_attention_match_jax():
    rng = np.random.RandomState(2)
    q = rng.randn(2, 7, 4, 8).astype(np.float32)
    k = rng.randn(2, 9, 4, 8).astype(np.float32)
    v = rng.randn(2, 9, 4, 8).astype(np.float32)
    _close(tattn.mha(*map(torch.from_numpy, (q, k, v))), jattn.mha(q, k, v))
    kg, vg = k[:, :, :2], v[:, :, :2]
    valid = np.array([5, 9], np.int32)
    tm = tattn.length_mask(torch.from_numpy(valid), 9, 2)
    jm = jattn.length_mask(jnp.asarray(valid), 9, 2)
    _close(tm, jm, 0)
    _close(tattn.gqa_attention(*map(torch.from_numpy, (q, kg, vg)), mask=tm),
           jattn.gqa_attention(q, kg, vg, mask=jm))


def test_length_mask_materialize_matches_jax():
    valid = np.array([3, 0, 7], np.int32)
    t = tattn.LengthMask(torch.from_numpy(valid), 4, 6).materialize(10)
    j = jattn.LengthMask(jnp.asarray(valid), jnp.int32(4), jnp.int32(6)).materialize(10)
    _close(t, j, 0)
    assert tuple(tattn.make_length_mask(5, batch=3).valid.tolist()) == (5, 5, 5)


# name, (b, t, h, hkv, d), valid, window, poison_from
FLASH_CASES = [
    ("mha", (1, 48, 4, 4, 32), None, None, None),
    ("gqa-2:1", (2, 40, 4, 2, 32), None, None, None),
    ("gqa-8:1", (1, 37, 8, 1, 16), None, None, None),
    ("head_dim-72", (1, 33, 2, 2, 72), None, None, None),
    ("head_dim-9", (2, 20, 3, 1, 9), [20, 11], None, None),
    ("valid-tail-poisoned", (1, 32, 2, 2, 16), [20], None, 20),
    ("per-row-valid-window", (2, 48, 4, 2, 16), [13, 30], (36, 41), None),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_attention_plain_matches_pallas(case):
    _, (b, t, h, hkv, d), valid, win, poison = case
    rng = np.random.RandomState(3)
    q = rng.randn(b, t, h, d).astype(np.float32)
    k = rng.randn(b, t, hkv, d).astype(np.float32)
    v = rng.randn(b, t, hkv, d).astype(np.float32)
    kw_t, kw_j = {}, {}
    if valid is not None:
        kw_t["valid_len"] = torch.tensor(valid, dtype=torch.int32)
        kw_j["valid_len"] = jnp.asarray(valid, jnp.int32)
    if win is not None:
        kw_t.update(gen_start=win[0], gen_end=win[1])
        kw_j.update(gen_start=jnp.int32(win[0]), gen_end=jnp.int32(win[1]))
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=16, block_k=16, **kw_j)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = ca.flash_attention_plain(tq, tk, tv, **kw_t)
    _close(out, ref)
    if poison is not None:
        tk2, tv2 = tk.clone(), tv.clone()
        tk2[:, poison:] = 1e6
        tv2[:, poison:] = 1e6
        _close(ca.flash_attention_plain(tq, tk2, tv2, **kw_t), out, 1e-6)


# name, (b, s, h, hkv, d), valid, window, poison_from
DECODE_CASES = [
    ("mha", (2, 40, 4, 4, 32), [40, 17], None, None),
    ("gqa-2:1", (2, 64, 4, 2, 32), [37, 37], None, None),
    ("gqa-8:1", (1, 50, 8, 1, 16), [29], None, None),
    ("head_dim-72", (1, 33, 2, 2, 72), [33], None, None),
    ("head_dim-9", (2, 20, 3, 1, 9), [20, 11], None, None),
    ("valid-tail-poisoned", (1, 32, 4, 2, 16), [10], None, 10),
    ("per-row-valid-window", (3, 48, 4, 2, 16), [7, 12, 3], (20, 25), None),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_attention_plain_matches_pallas(case):
    _, (b, s, h, hkv, d), valid, win, poison = case
    rng = np.random.RandomState(4)
    q = rng.randn(b, 1, h, d).astype(np.float32)
    k = rng.randn(b, s, hkv, d).astype(np.float32)
    v = rng.randn(b, s, hkv, d).astype(np.float32)
    kw_t, kw_j = {}, {}
    if win is not None:
        kw_t.update(gen_start=win[0], gen_end=win[1])
        kw_j.update(gen_start=jnp.int32(win[0]), gen_end=jnp.int32(win[1]))
    ref = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(valid, jnp.int32), **kw_j)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tvalid = torch.tensor(valid, dtype=torch.int32)
    out = ca.decode_attention_plain(tq, tk, tv, tvalid, **kw_t)
    _close(out, ref)
    if poison is not None:
        tk2, tv2 = tk.clone(), tv.clone()
        tk2[:, poison:] = 1e9
        tv2[:, poison:] = 1e9
        _close(ca.decode_attention_plain(tq, tk2, tv2, tvalid, **kw_t), out, 0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.RandomState(5)
    q = torch.from_numpy(rng.randn(1, 12, 4, 16).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 12, 2, 16).astype(np.float32))
    v = torch.from_numpy(rng.randn(1, 12, 2, 16).astype(np.float32))
    ca.reset_launch_counts()
    assert torch.equal(ca.flash_attention(q, k, v), ca.flash_attention_plain(q, k, v))
    assert torch.equal(ca.decode_attention(q[:, :1], k, v, 9),
                       ca.decode_attention_plain(q[:, :1], k, v, 9))
    assert ca.launch_counts() == {"flash_attention": 0, "decode_attention": 0}
    assert KERNELS.flash is ca.flash_attention and PLAIN.decode is ca.decode_attention_plain


def test_non_cpu_tensor_never_falls_back_to_the_plain_version():
    """A tensor off the CPU must launch the kernel or raise."""
    q = torch.empty(1, 8, 2, 16, device="meta")
    k = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ca.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        ca.decode_attention(q[:, :1], k, k, 4)
    assert ca.launch_counts() == {"flash_attention": 0, "decode_attention": 0}


def test_greedy_matches_jax_argmax():
    logits = np.random.RandomState(6).randn(3, 50).astype(np.float32)
    logits[1, [4, 9]] = 10.0  # tie: both take the first index
    from paligemma_tpu.ops.sampling import greedy as j_greedy

    got = greedy(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_greedy(jnp.asarray(logits))))
