"""The port's whole-sequence GRU (``ops/kernels/rnn_train.gru_sequence``,
plain versions on the CPU) against the JAX package's Pallas
``gru_sequence`` in interpret mode, and against torch autograd through
the port's own ``rnn_scan``.  Inputs from a seed with numpy; sizes of
tests/test_rnn_train.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplernn_pase_tpu.models import rnn_cells as jrc
from samplernn_pase_tpu.ops.pallas.rnn_train import gru_sequence as j_gru
from samplernn_pase_tpu_torch.models import rnn_cells as trc
from samplernn_pase_tpu_torch.ops.kernels import rnn_train as trt

B, N, H = 4, 6, 8


def _setup(seed):
    params = jax.device_get(jrc.init_rnn_layer(jax.random.PRNGKey(seed), H,
                                               H, "gru"))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, B, H)).astype(np.float32)
    h0 = rng.normal(size=(B, H)).astype(np.float32)
    return params, x, h0


def _loss(xp, h_seq, h_fin):
    # the loss of tests/test_rnn_train.py:46-51
    return xp.sum(h_seq * xp.cos(h_seq)) + 2.0 * xp.sum(h_fin)


def _jax_run(params, x, h0, weights_dtype):
    def f(p, x, h0):
        hs, hf = j_gru(x, h0, p["w_ih"], p["b_ih"], p["w_hh"], p["b_hh"],
                       weights_dtype, True)
        return _loss(jnp, hs, hf), (hs, hf)

    (_, (hs, hf)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(x),
                                            jnp.asarray(h0))
    gp, gx, gh = grads
    want = {"x": gx, "h0": gh}
    want.update({k: gp[k] for k in ("w_ih", "b_ih", "w_hh", "b_hh")})
    return np.asarray(hs), np.asarray(hf), jax.device_get(want)


def _torch_run(params, x, h0, weights_dtype):
    leaves = {k: torch.tensor(np.asarray(v), requires_grad=True)
              for k, v in params.items()}
    leaves["x"] = torch.tensor(x, requires_grad=True)
    leaves["h0"] = torch.tensor(h0, requires_grad=True)
    hs, hf = trt.gru_sequence(leaves["x"], leaves["h0"], leaves["w_ih"],
                              leaves["b_ih"], leaves["w_hh"], leaves["b_hh"],
                              weights_dtype)
    _loss(torch, hs, hf).backward()
    return hs.detach().numpy(), hf.detach().numpy(), leaves


def test_forward_matches_jax_kernel():
    params, x, h0 = _setup(0)
    hs, hf, _ = _torch_run(params, x, h0, "float32")
    want_hs, want_hf = j_gru(jnp.asarray(x), jnp.asarray(h0),
                             params["w_ih"], params["b_ih"], params["w_hh"],
                             params["b_hh"], "float32", True)
    np.testing.assert_allclose(hs, np.asarray(want_hs), atol=1e-5)
    np.testing.assert_allclose(hf, np.asarray(want_hf), atol=1e-5)


# float32: the bar of tests/test_rnn_train.py (2e-4).  bfloat16: both
# sides round at the same points (x, h_{t-1}, dh_seq, d_xg/d_hg to bf16;
# h_seq and dx stored in bf16), so they differ only where a float32 sum,
# taken in another order, lands on the other side of a bf16 rounding
# boundary: one bf16 ulp, 2**-8 of the value, at most.  The bound is one
# ulp of each array's largest value, 2**-8 * max|want|.
@pytest.mark.parametrize("weights_dtype", ["float32", "bfloat16"])
def test_gradients_match_jax_kernel(weights_dtype):
    params, x, h0 = _setup(1)
    hs, hf, got = _torch_run(params, x, h0, weights_dtype)
    want_hs, want_hf, want = _jax_run(params, x, h0, weights_dtype)
    for name in ("x", "h0", "w_ih", "b_ih", "w_hh", "b_hh"):
        g, w = got[name].grad.numpy(), np.asarray(want[name])
        if weights_dtype == "float32":
            np.testing.assert_allclose(g, w, atol=2e-4, rtol=2e-4,
                                       err_msg=name)
        else:
            assert np.abs(g - w).max() <= 2 ** -8 * np.abs(w).max(), name
    bound = 1e-5 if weights_dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(hs, want_hs, atol=bound)
    np.testing.assert_allclose(hf, want_hf, atol=bound)


def test_plain_backward_matches_autograd_scan():
    """In float32 the reference's VJP is the exact gradient, so the
    port's plain backward equals torch autograd through ``rnn_scan``."""
    params, x, h0 = _setup(2)
    _, _, got = _torch_run(params, x, h0, "float32")
    leaves = {k: torch.tensor(np.asarray(v), requires_grad=True)
              for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    th = torch.tensor(h0, requires_grad=True)
    xg = trc.precompute_inputs(leaves, tx.transpose(0, 1), "float32")
    hs, hf = trc.rnn_scan(leaves, th, xg, "gru", "float32")
    _loss(torch, hs.transpose(0, 1), hf).backward()
    leaves.update(x=tx, h0=th)
    for name, t in leaves.items():
        np.testing.assert_allclose(got[name].grad.numpy(), t.grad.numpy(),
                                   atol=2e-5, rtol=2e-5, err_msg=name)


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the kernel wrappers run their plain versions and
    count no launch."""
    params, x, h0 = _setup(3)
    p = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    args = (torch.from_numpy(x), torch.from_numpy(h0), p["w_ih"],
            p["b_ih"], p["w_hh"], p["b_hh"], "float32")
    trt.reset_launches()
    got = trt.gru_sequence_fwd(*args)
    want = trt.gru_sequence_fwd_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].shape == (N + 1, B, H) and got[2].shape == (N, B, 3 * H)
    assert not any(trt.LAUNCHES.values())
