"""The port's whole-sequence LSTM (``ops/kernels/rnn_train.lstm_sequence``,
K5's plain versions on the CPU) against the JAX package's Pallas
``lstm_sequence`` in interpret mode and against torch autograd through the
port's own ``rnn_scan``; and a 3-tier LSTM model on the kernel route
against the JAX package's (its Pallas kernel, interpreted): forward, NLL,
gradients and three train steps.  Inputs from a seed with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samplernn_pase_tpu.config import SampleRNNConfig as JCfg
from samplernn_pase_tpu.models import rnn_cells as jrc
from samplernn_pase_tpu.models import samplernn as jsrnn
from samplernn_pase_tpu.ops.pallas.rnn_train import lstm_sequence as j_lstm
from samplernn_pase_tpu.train import optim as joptim
from samplernn_pase_tpu.train import trainer as jtrainer
from samplernn_pase_tpu_torch import convert
from samplernn_pase_tpu_torch.config import SampleRNNConfig as TCfg
from samplernn_pase_tpu_torch.models import rnn_cells as trc
from samplernn_pase_tpu_torch.models import samplernn as tsrnn
from samplernn_pase_tpu_torch.ops.kernels import rnn_train as trt
from samplernn_pase_tpu_torch.train import optim as toptim
from samplernn_pase_tpu_torch.train import trainer as ttrainer
from samplernn_pase_tpu_torch.tree import tree_leaves, tree_map

B, N, H = 4, 6, 8
NAMES = ("x", "hc0", "w_ih", "b_ih", "w_hh", "b_hh")


def _setup(seed):
    params = jax.device_get(jrc.init_rnn_layer(jax.random.PRNGKey(seed), H,
                                               H, "lstm"))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, B, H)).astype(np.float32)
    hc0 = rng.normal(size=(2, B, H)).astype(np.float32)
    return params, x, hc0


def _loss(xp, h_seq, hc_fin):
    # the loss of tests/test_rnn_train.py:146-147
    return (xp.sum(h_seq * xp.cos(h_seq)) + 2.0 * xp.sum(hc_fin[0])
            + 0.5 * xp.sum(hc_fin[1]))


def _jax_run(params, x, hc0, weights_dtype):
    def f(p, x, hc0):
        hs, hf = j_lstm(x, hc0, p["w_ih"], p["b_ih"], p["w_hh"], p["b_hh"],
                        weights_dtype, True)
        return _loss(jnp, hs, hf), (hs, hf)

    (_, (hs, hf)), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(x),
                                            jnp.asarray(hc0))
    gp, gx, gh = grads
    want = {"x": gx, "hc0": gh}
    want.update({k: gp[k] for k in ("w_ih", "b_ih", "w_hh", "b_hh")})
    return np.asarray(hs), np.asarray(hf), jax.device_get(want)


def _torch_run(params, x, hc0, weights_dtype):
    leaves = {k: torch.tensor(np.asarray(v), requires_grad=True)
              for k, v in params.items()}
    leaves["x"] = torch.tensor(x, requires_grad=True)
    leaves["hc0"] = torch.tensor(hc0, requires_grad=True)
    hs, hf = trt.lstm_sequence(leaves["x"], leaves["hc0"], leaves["w_ih"],
                               leaves["b_ih"], leaves["w_hh"],
                               leaves["b_hh"], weights_dtype)
    _loss(torch, hs, hf).backward()
    return hs.detach().numpy(), hf.detach().numpy(), leaves


def test_forward_matches_jax_kernel():
    params, x, hc0 = _setup(0)
    hs, hf, _ = _torch_run(params, x, hc0, "float32")
    want_hs, want_hf = j_lstm(jnp.asarray(x), jnp.asarray(hc0),
                              params["w_ih"], params["b_ih"], params["w_hh"],
                              params["b_hh"], "float32", True)
    assert hf.shape == (2, B, H)
    np.testing.assert_allclose(hs, np.asarray(want_hs), atol=1e-5)
    np.testing.assert_allclose(hf, np.asarray(want_hf), atol=1e-5)


# float32: the bar of tests/test_rnn_train.py (2e-4).  bfloat16: both
# sides round at the same points (x, h_{t-1}, dh_seq and the gate
# gradients to bf16; h_seq, c_seq and dx stored in bf16; c_{t-1} and c_t
# read back rounded), so they differ only where a float32 sum, taken in
# another order, lands on the other side of a bf16 rounding boundary: one
# bf16 ulp, 2**-8 of the value, at most.  The bound is one ulp of each
# array's largest value, 2**-8 * max|want|.
@pytest.mark.parametrize("weights_dtype", ["float32", "bfloat16"])
def test_gradients_match_jax_kernel(weights_dtype):
    params, x, hc0 = _setup(1)
    hs, hf, got = _torch_run(params, x, hc0, weights_dtype)
    want_hs, want_hf, want = _jax_run(params, x, hc0, weights_dtype)
    for name in NAMES:
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
    params, x, hc0 = _setup(2)
    _, _, got = _torch_run(params, x, hc0, "float32")
    leaves = {k: torch.tensor(np.asarray(v), requires_grad=True)
              for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    th = torch.tensor(hc0, requires_grad=True)
    xg = trc.precompute_inputs(leaves, tx.transpose(0, 1), "float32")
    hs, hf = trc.rnn_scan(leaves, th, xg, "lstm", "float32")
    _loss(torch, hs.transpose(0, 1), hf).backward()
    leaves.update(x=tx, hc0=th)
    for name, t in leaves.items():
        np.testing.assert_allclose(got[name].grad.numpy(), t.grad.numpy(),
                                   atol=2e-5, rtol=2e-5, err_msg=name)


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors K5's wrappers run their plain versions and count no
    launch; the residual g is the gate pre-activations."""
    params, x, hc0 = _setup(3)
    p = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    h0, c0 = torch.from_numpy(hc0[0]), torch.from_numpy(hc0[1])
    args = (torch.from_numpy(x), h0, c0, p["w_ih"], p["b_ih"], p["w_hh"],
            p["b_hh"], "float32")
    trt.reset_launches()
    got = trt.lstm_sequence_fwd(*args)
    want = trt.lstm_sequence_fwd_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    hbuf, c_seq, _, _, g = got
    assert hbuf.shape == (N + 1, B, H) and g.shape == (N, B, 4 * H)
    torch.testing.assert_close(
        g[0], torch.from_numpy(x[0]) @ p["w_ih"] + p["b_ih"]
        + h0 @ p["w_hh"] + p["b_hh"])
    rng = np.random.default_rng(4)
    dh_seq = torch.from_numpy(rng.normal(size=(N, B, H)).astype(np.float32))
    bargs = (torch.from_numpy(x), c0, p["w_ih"], p["w_hh"], hbuf, c_seq, g,
             dh_seq, h0, c0, "float32")
    for a, b in zip(trt.lstm_sequence_bwd(*bargs),
                    trt.lstm_sequence_bwd_plain(*bargs)):
        assert torch.equal(a, b)
    assert not any(trt.LAUNCHES.values())


# ----------------------------------------------------- the model --

LSTM3 = dict(frame_sizes=(4, 2, 2), embed_dim=8, rnn_type="lstm",
             learn_h0=True, pallas_train_rnn=True, compute_dtype="float32")


def _models(seed, dim):
    jc = JCfg(**LSTM3, dim=dim)
    jp = jax.device_get(jsrnn.init_params(jax.random.PRNGKey(seed), jc))
    for tier in jp["tiers"]:      # a learned h0 that is not zero
        tier["h0"] = tier["h0"] + 0.3
    return jc, TCfg(**LSTM3, dim=dim), jp, convert.params_from_jax(jp)


def test_lstm_model_forward_and_gradients_match_jax():
    """dim 128: the width at which the JAX package takes its Pallas
    training kernel (dim % 128 == 0), so both sides run their sequence
    kernels."""
    jc, tc, jp, tp = _models(0, 128)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (2, jc.lookback * 5), np.int32)
    y = x[:, jc.lookback:]
    jstate = jsrnn.initial_state(jp, jc, 2)
    tstate = tsrnn.initial_state(tp, tc, 2)
    jlog, jnew = jsrnn.forward(jp, jc, jnp.asarray(x), jstate)
    tlog, tnew = tsrnn.forward(tp, tc, torch.from_numpy(x), tstate)
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               atol=2e-4)
    for a, b in zip(tnew, jnew):
        assert a.shape == (1, 2, 2, 128)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=2e-4)
    jn = float(jsrnn.nll_bits(jlog, jnp.asarray(y)))
    assert abs(float(tsrnn.nll_bits(tlog, torch.from_numpy(y))) - jn) < 1e-4

    def jloss(p):
        return jsrnn.loss_fn(p, jc, jnp.asarray(x), jnp.asarray(y),
                             jstate)[0]

    jg = jax.tree.leaves(jax.grad(jloss)(jp))
    trt.reset_launches()
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    nll, _ = tsrnn.loss_fn(leaves, tc, torch.from_numpy(x),
                           torch.from_numpy(y), tstate)
    tg = torch.autograd.grad(nll, tree_leaves(leaves), allow_unused=True)
    for g, w in zip(tg, jg):
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), atol=5e-4, rtol=5e-4)
    # plain versions on the CPU: no launch
    assert not any(trt.LAUNCHES.values())


EPS, B2 = 1e-8, 0.999      # Adam's eps and b2 in both packages' defaults


def _three_train_steps(dim, seed):
    """Three TBPTT steps of the 3-tier LSTM on the kernel route in both
    packages, NLL within 1e-4 bits at each (the bound's reason is at
    tests/test_torch_train.py's test_train_steps_match_jax).  Returns the
    params and hiddens of both, and per param leaf the components at which
    some step's Adam denominator sqrt(v_hat) lay in (0, 10 eps): there the
    update's size follows the gradient's last float32 bits, so its value
    depends on the order of the float32 sums.  (Where v is 0 the gradient
    has always been 0 and both updates are 0.)"""
    jc, tc, jp, tp = _models(seed, dim)
    rng = np.random.default_rng(seed + 1)
    xs = rng.integers(0, 256, (3, 2, jc.lookback * 3), np.int32)
    ys = xs[:, :, jc.lookback:]
    rs = np.array([[1, 1], [0, 1], [0, 0]], np.float32)
    jtx = joptim.make_optimizer(1e-3, 1.0)
    ttx = toptim.make_optimizer(1e-3, 1.0)
    jstep = jtrainer.make_train_step(jc, jtx)
    tstep = ttrainer.make_train_step(tc, ttx)
    jpar = jax.tree.map(jnp.asarray, jp)
    jopt, jh = jtx.init(jpar), jsrnn.initial_state(jpar, jc, 2)
    tpar, topt = tp, ttx.init(tp)
    th = tsrnn.initial_state(tp, tc, 2)
    near_eps = None
    for k in range(3):
        jpar, jopt, jh, jn = jstep(jpar, jopt, jh, jnp.asarray(xs[k]),
                                   jnp.asarray(ys[k]), jnp.asarray(rs[k]))
        tpar, topt, th, tn = tstep(tpar, topt, th, torch.from_numpy(xs[k]),
                                   torch.from_numpy(ys[k]),
                                   torch.from_numpy(rs[k]))
        assert abs(float(tn) - float(jn)) < 1e-4, (k, float(tn), float(jn))
        nu = jax.tree.leaves(jax.device_get(jopt[1][0].nu))
        near = [(v > 0) & (np.sqrt(v / (1 - B2 ** (k + 1))) < 10 * EPS)
                for v in nu]
        near_eps = near if near_eps is None else [
            a | b for a, b in zip(near_eps, near)]
    return (tree_leaves(tpar), jax.tree.leaves(jax.device_get(jpar)), th,
            jh, near_eps)


def test_lstm_train_steps_match_jax():
    """Three train steps at dim 16, where the JAX package scans (below dim
    128; the float32 gradients of its kernel and of its scan agree,
    tests/test_rnn_train.py): params and hiddens within 1e-5, with no
    component exempt."""
    tpar, jpar, th, jh, _ = _three_train_steps(16, 3)
    for a, b in zip(tpar, jpar):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0)
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_lstm_train_steps_match_jax_kernel():
    """Three train steps at dim 128, where the JAX package runs its Pallas
    LSTM kernel: params and hiddens within 1e-5, except at the components
    whose Adam denominator came within 10 eps of zero (see
    ``_three_train_steps``; about 0.3% of them, with differences up to
    1.1e-5 measured).  Those must be under 1% of all, and each may move
    at most one step size (lr 1e-3) per step away from JAX's."""
    tpar, jpar, th, jh, near_eps = _three_train_steps(128, 3)
    n_near = sum(int(m.sum()) for m in near_eps)
    assert n_near <= 1e-2 * sum(m.size for m in near_eps), n_near
    for a, b, m in zip(tpar, jpar, near_eps):
        a = a.numpy()
        np.testing.assert_allclose(a[~m], b[~m], atol=1e-5, rtol=0)
        assert np.abs(a[m] - b[m]).max(initial=0.0) <= 3e-3
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
