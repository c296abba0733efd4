"""Port: the iMAML system (``metatts_torch/algorithms/imaml.py``) against
the JAX package's ``algorithms/imaml.py``, at the tiny config of
tests/helpers.py (hidden 32, 1 + 1 layers, fp32; 2 shots, 2 queries, 2
inner steps, 2 CG steps, 2 episodes), dropout patched out on both sides.
Inputs come from numpy with a fixed seed and parameters cross over
through metatts_torch.convert; each JAX reference is compiled once.

Then the quadratic anchors of tests/test_imaml_correctness.py through the
port's production ``_episode_hypergrad``: a stub adaptor whose inner
problem has a closed-form implicit gradient, with a w-u cross term so that
the frozen cross-Hessian term is load-bearing.

The JAX references sum the CG's inner products (``imaml._tree_dot``) in
blocks.  XLA's CPU backend sums ``jnp.vdot`` of a leaf in one fp32
accumulator, and the postnet's 512 x 512 x 5 conv kernels hold 1.3M
entries each: a squared gradient summed that way loses 0.35% of |g_w|^2
(653.50 against 655.81 in float64 and in the port, here), and at a random
init, where the second CG step meets negative curvature and freezes, the
first step's alpha = |g|^2 / g'Ag scales the whole hypergradient by that
error.  Summed in blocks, the JAX package gives its own float64 value.

Tolerances (fp32; only the order of summation differs): hypergradients
rel L2 1e-4 over all parameters; losses rtol 1e-5; CG solutions rtol 1e-5;
parameter deltas of an Adam step atol 0.1 x lr (tests/test_torch_train.py);
the quadratic anchors rel 1e-3 and cosine 0.999999, as the JAX tests hold
the JAX package.
"""

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import metatts_tpu.models.nn as jnn
from metatts_tpu.algorithms import imaml as jimaml
from metatts_tpu.algorithms.adapt import Adaptor as JaxAdaptor
from metatts_tpu.train.optim import make_optimizer
from metatts_torch.algorithms import get_system
from metatts_torch.algorithms.adapt import partition
from metatts_torch.algorithms.base import episode
from metatts_torch.algorithms.imaml import IMAMLSystem, tree_cg
from metatts_torch.convert import fs2_state_dict_from_jax, load_fs2_from_jax
from metatts_torch.data.collate import Batch as TBatch
from metatts_torch.models import nn as tnn
from metatts_torch.models.loss import LossValues

from helpers import (tiny_model_cfg, tiny_preprocess_cfg, tiny_train_cfg,
                     algorithm_cfg, synth_batch, STATS)
from torch_port_helpers import fs2_params, one_torch_thread  # noqa: F401

HYPER_TOL = 1e-4


def _blocked_dot(a, b):
    """``imaml._tree_dot`` with each leaf's products summed in ~sqrt(n)
    blocks, then the block sums."""
    def one(x, y):
        v = (x * y).ravel()
        k = int(np.ceil(np.sqrt(v.shape[0])))
        return jnp.pad(v, (0, k * k - v.shape[0])).reshape(k, k).sum(axis=1).sum()
    return sum(jax.tree.leaves(jax.tree.map(one, a, b)))


@pytest.fixture(scope="module", autouse=True)
def reference_patches():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnn, "dropout", lambda rng, x, rate, train: x)
        mp.setattr(tnn, "dropout", lambda x, rate, train, generator: x)
        mp.setattr(jimaml, "_tree_dot", _blocked_dot)
        yield


def _t(b):
    return TBatch(*(None if v is None else torch.from_numpy(np.array(v)) for v in b))


def _acfg(**imaml):
    acfg = algorithm_cfg("imaml")
    acfg["adapt"]["train"].update(lr=0.01)      # second-order terms show
    acfg["adapt"]["imaml"] = dict({"reg_param": 0.5, "cg_steps": 2}, **imaml)
    return acfg


def _train_cfg(clip):
    tcfg = copy.deepcopy(tiny_train_cfg())
    # eps 1e-6 keeps parameters whose gradient is 0 up to rounding still
    # in Adam's first step on both sides (tests/test_torch_train.py)
    tcfg["optimizer"].update(eps=1e-6, grad_clip_thresh=clip)
    return tcfg


def _rel_l2(got, ref):
    num = sum(float(((got[n].detach().double() - torch.from_numpy(np.asarray(ref[n], np.float64)))
                     ** 2).sum()) for n in ref)
    den = sum(float((np.asarray(ref[n], np.float64) ** 2).sum()) for n in ref)
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def setup():
    pcfg, mcfg, acfg = tiny_preprocess_cfg(), tiny_model_cfg(), _acfg()
    params, state = fs2_params(pcfg, mcfg, acfg, STATS, 4)
    rng = np.random.RandomState(9)
    sup = synth_batch(rng, B=2, L=12, T=48, n_mels=8, episode_axis=2)
    qry = synth_batch(rng, B=2, L=12, T=48, n_mels=8, episode_axis=2)
    jsys = jimaml.IMAMLSystem.__new__(jimaml.IMAMLSystem)
    jsys.acfg, jsys.adaptor = acfg, JaxAdaptor(pcfg, mcfg, acfg)
    hyper = jax.jit(jsys._episode_hypergrad)
    refs = [hyper(params, state, jax.tree.map(lambda x: x[e], sup),
                  jax.tree.map(lambda x: x[e], qry), jax.random.PRNGKey(e))
            for e in range(2)]
    return dict(pcfg=pcfg, mcfg=mcfg, acfg=acfg, params=params, state=state,
                sup=sup, qry=qry, jsys=jsys, refs=refs)


def _port_system(s, tcfg=None, acfg=None):
    system = IMAMLSystem(s["pcfg"], s["mcfg"], tcfg or tiny_train_cfg(), acfg or s["acfg"],
                         STATS, 4, device="cpu")
    load_fs2_from_jax(system.model, s["params"], s["state"])
    return system


def _by_name(s, tree):
    """A JAX params-layout tree -> parameter name -> array (the port's
    parameters only: the pitch and energy bins are buffers here)."""
    return {n: v.numpy() for n, v in fs2_state_dict_from_jax(
        jax.tree.map(np.asarray, tree), s["state"]).items()
        if "running_" not in n and not n.endswith("_bins")}


# ------------------------------------------------------------------ CG

@pytest.mark.parametrize("kind", ["spd", "indefinite"])
def test_tree_cg_matches_jax(kind):
    """Five iterations on a 2-tensor system: SPD, and indefinite, where a
    direction of negative curvature freezes the iterate (pap <= 1e-20)."""
    rng = np.random.RandomState(0)
    Q = np.linalg.qr(rng.randn(7, 7))[0]
    eig = np.linspace(0.2, 3.0, 7) if kind == "spd" else np.linspace(-2.0, 3.0, 7)
    A = (Q @ np.diag(eig) @ Q.T).astype(np.float32)
    b = [rng.randn(3).astype(np.float32), rng.randn(4).astype(np.float32)]

    def split(v):
        return [v[:3], v[3:]]

    ref = jimaml.tree_cg(lambda p: split(jnp.asarray(A) @ jnp.concatenate(p)),
                         [jnp.asarray(x) for x in b], 5)
    At = torch.from_numpy(A)
    got = tree_cg(lambda p: split(At @ torch.cat(p)), [torch.from_numpy(x) for x in b], 5)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
    if kind == "spd":     # 5 of 7 Krylov steps already near the solution
        x = torch.cat(got).numpy()
        assert np.linalg.norm(A @ x - np.concatenate(b)) < 0.5 * np.linalg.norm(np.concatenate(b))


# ------------------------------------------------------------ hypergradient

def test_episode_hypergrad_matches_jax(setup):
    """One episode's implicit meta-gradient at full support, every
    parameter: the adapted modules' lr*reg*x and the frozen encoder's
    direct gradient plus its cross-Hessian term; and the query losses."""
    s = setup
    system = _port_system(s)
    hyper, losses = system._episode_hypergrad(
        system.params, episode(_t(s["sup"]), 0), episode(_t(s["qry"]), 0), 5)
    ref_h, ref_l = s["refs"][0]
    ref = _by_name(s, ref_h)
    assert hyper.keys() == set(ref) == set(system.params)
    assert _rel_l2(hyper, ref) < HYPER_TOL
    enc = {n: ref[n] for n in ref if n.startswith("encoder.")}
    assert _rel_l2({n: hyper[n] for n in enc}, enc) < HYPER_TOL
    for name, a, b in zip(losses._fields, losses, ref_l):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-5, err_msg=name)
    for n, p in system.params.items():     # the step's inputs are untouched
        assert p.grad is None, n


CLIP = 1.0        # config/train/base.yaml's; it binds on this episode pair


@pytest.fixture(scope="module")
def step_ref(setup):
    """The JAX ``_train_step`` at E=2 with the clip at ``CLIP``."""
    s = setup
    jsys = copy.copy(s["jsys"])
    jsys.tcfg = _train_cfg(CLIP)
    jsys.tx, _ = make_optimizer(s["mcfg"], jsys.tcfg)
    return jax.jit(jsys._train_step)(
        s["params"], s["state"], jsys.tx.init(s["params"]), s["sup"], s["qry"],
        jax.random.PRNGKey(0))


@pytest.mark.parametrize("clip", [CLIP, 1e6])
def test_train_step_matches_jax(setup, step_ref, clip):
    """``train_step`` (E=2): the mean hypergradient, its NaN-zeroing and
    global clip against the JAX episodes' mean, with a clip that binds and
    one that does not; at the binding clip the parameters after the
    optimizer against the JAX ``_train_step``, and the mean losses."""
    s = setup
    tcfg = _train_cfg(clip)
    system = _port_system(s, tcfg)
    before = {n: p.detach().clone() for n, p in system.params.items()}
    sup, qry = _t(s["sup"]), _t(s["qry"])
    _, grads = system._train_step(sup, qry, 3)
    r0, r1 = (_by_name(s, r[0]) for r in s["refs"])
    mean = {n: (r0[n] + r1[n]) / 2 for n in r0}
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in mean.values()))
    want = {n: v * min(1.0, clip / norm) for n, v in mean.items()}
    assert _rel_l2(grads, want) < HYPER_TOL
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
    if clip == CLIP:
        assert norm > 2 * clip
        np.testing.assert_allclose(gnorm, clip, rtol=1e-5)
    else:
        np.testing.assert_allclose(gnorm, norm, rtol=1e-4)
        return

    losses = system.train_step(sup, qry)
    assert system.global_step == 1
    new_params, _, losses_r = step_ref
    for name, a, b in zip(losses._fields, losses, losses_r):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-5, err_msg=name)
    after = _by_name(s, new_params)
    lr = float(make_optimizer(s["mcfg"], tcfg)[1](1))
    moved = 0
    for n, p in system.params.items():
        d_got = (p.detach() - before[n]).numpy()
        np.testing.assert_allclose(d_got, after[n] - before[n].numpy(), atol=0.1 * lr,
                                   rtol=0, err_msg=n)
        moved += int((np.abs(d_got) > 0.5 * lr).sum())
    assert moved > 0.3 * sum(p.numel() for p in system.params.values())


def test_get_system_and_non_finite_hypergradients_zeroed(setup, monkeypatch):
    """``get_system("imaml")`` is the port's system; a non-finite entry of
    a hypergradient is zeroed before the clip, as in the JAX step."""
    assert get_system("imaml") is IMAMLSystem
    s = setup
    system = _port_system(s, _train_cfg(1e6))
    orig = system._episode_hypergrad

    def poisoned(*args):
        h, lv = orig(*args)
        h = dict(h)
        h["mel_linear.bias"] = h["mel_linear.bias"].clone()
        h["mel_linear.bias"][0] = float("nan")
        h["mel_linear.bias"][1] = float("inf")
        return h, lv
    monkeypatch.setattr(system, "_episode_hypergrad", poisoned)
    _, grads = system._train_step(_t(s["sup"]), _t(s["qry"]), 3)
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert grads["mel_linear.bias"][:2].tolist() == [0.0, 0.0]


# ------------------------------------------------- quadratic ground truth

class QuadraticAdaptor:
    """L(w, u; batch) = (1+t)/2 w'Aw + w'Cu + 1/2 u'Bu + t (a'w + b'u) with
    t = mean(batch.mels): A PSD with eigenvalues in [0.1, 2], so lr 0.3 /
    reg 1 contract the proximal map; the w'Cu term makes dPhi/dfrozen
    nonzero (tests/test_imaml_correctness.py's ``QuadraticAdaptor``)."""

    modules = ("enc",)

    def __init__(self, d=8, seed=0):
        rng = np.random.RandomState(seed)
        Q = np.linalg.qr(rng.randn(d, d))[0]
        f = lambda a: torch.from_numpy(np.asarray(a, np.float32))
        self.A = f(Q @ np.diag(np.linspace(0.1, 2.0, d)) @ Q.T)
        self.B = torch.eye(d)
        self.C = f(0.5 * rng.randn(d, d))
        self.a, self.b = f(rng.randn(d)), f(rng.randn(d))
        self.d = d
        rngp = np.random.RandomState(seed + 1)
        self.init_params = {"enc": f(rngp.randn(d)), "dec": f(rngp.randn(d))}

    def forward(self, params, batch, **kw):
        return params["enc"], params["dec"], batch.mels.mean()

    def loss(self, batch, out):
        w, u, t = out
        val = ((1.0 + t) * 0.5 * w @ self.A @ w + w @ self.C @ u
               + 0.5 * u @ self.B @ u + t * (self.a @ w + self.b @ u))
        return LossValues(val, val, val, val, val, val)

    def analytic_hypergrad(self, theta0, u, sup_t, qry_t, reg):
        """Rajeswaran et al. eq. 6, in float64."""
        A, C, B = (x.double() for x in (self.A, self.C, self.B))
        a, b = self.a.double(), self.b.double()
        theta0, u = theta0.double(), u.double()
        M = (1.0 + sup_t) * A + reg * torch.eye(self.d, dtype=torch.float64)
        w_star = torch.linalg.solve(M, reg * theta0 - C @ u - sup_t * a)
        g_w = (1.0 + qry_t) * A @ w_star + C @ u + qry_t * a
        g_u = C.T @ w_star + B @ u + qry_t * b
        m_gw = torch.linalg.solve(M, g_w)
        return {"enc": reg * m_gw, "dec": g_u - C.T @ m_gw}


def _quad_system(steps=60, cg_steps=24, reg=1.0, lr=0.3, batch_size=None, seed=0):
    system = IMAMLSystem.__new__(IMAMLSystem)
    system.acfg = algorithm_cfg("imaml")
    system.acfg["adapt"]["train"].update(steps=steps, lr=lr)
    system.acfg["adapt"]["imaml"] = {"reg_param": reg, "cg_steps": cg_steps,
                                     "batch_size": batch_size}
    system.adaptor = QuadraticAdaptor(seed=seed)
    return system, system.adaptor


def _quad_episode(seed=0):
    rng = np.random.RandomState(seed)
    return (_t(synth_batch(rng, B=3, L=4, T=8, n_mels=4, n_speakers=4)),
            _t(synth_batch(rng, B=2, L=4, T=8, n_mels=4, n_speakers=4)))


def _rel_cos(h, u):
    h, u = h.double().flatten(), u.double().flatten()
    return float((h - u).norm() / u.norm()), float(h @ u / (h.norm() * u.norm()))


def test_quadratic_hypergrad_matches_closed_form():
    """Every term at once: the CG matvec, theta0's lr*reg*x, the frozen
    module's direct gradient and its cross-Hessian term."""
    system, quad = _quad_system()
    sup, qry = _quad_episode()
    hyper, losses = system._episode_hypergrad(quad.init_params, sup, qry, 7)
    assert torch.isfinite(losses.total)
    want = quad.analytic_hypergrad(quad.init_params["enc"], quad.init_params["dec"],
                                   float(sup.mels.double().mean()),
                                   float(qry.mels.double().mean()), 1.0)
    for key in ("enc", "dec"):
        rel, cos = _rel_cos(hyper[key], want[key])
        assert rel < 1e-3 and cos > 0.999999, (key, rel, cos)


def test_quadratic_hypergrad_matches_unrolled_gradient():
    """The implicit gradient against autograd through the unrolled
    proximal inner loop (the production ``_inner_loss``), converged."""
    system, quad = _quad_system()
    sup, qry = _quad_episode()
    hyper, _ = system._episode_hypergrad(quad.init_params, sup, qry, 7)
    theta0, frozen = partition({k: v.clone().requires_grad_() for k, v in
                                quad.init_params.items()}, quad.modules)
    w = dict(theta0)
    for _ in range(60):
        g = torch.autograd.grad(system._inner_loss(w, frozen, theta0, sup, None),
                                list(w.values()), create_graph=True)
        w = {k: v - 0.3 * gi for (k, v), gi in zip(w.items(), g)}
    total = quad.loss(qry, quad.forward({**w, **frozen}, qry)).total
    unrolled = dict(zip(["enc", "dec"], torch.autograd.grad(
        total, [theta0["enc"], frozen["dec"]])))
    for key in ("enc", "dec"):
        rel, cos = _rel_cos(hyper[key], unrolled[key])
        assert rel < 1e-3 and cos > 0.999999, (key, rel, cos)


def test_quadratic_frozen_cross_term_is_load_bearing():
    """Without the (dPhi/dfrozen)^T x term the frozen gradient misses the
    closed form by far more than the tolerance."""
    system, quad = _quad_system()
    sup, qry = _quad_episode()
    hyper, _ = system._episode_hypergrad(quad.init_params, sup, qry, 7)
    want = quad.analytic_hypergrad(quad.init_params["enc"], quad.init_params["dec"],
                                   float(sup.mels.double().mean()),
                                   float(qry.mels.double().mean()), 1.0)
    # the direct gradient alone: dL_qry/du at w*
    direct = want["dec"] + quad.C.double().T @ (want["enc"] / 1.0)
    assert _rel_cos(direct, want["dec"])[0] > 100 * 1e-3
    assert _rel_cos(hyper["dec"], want["dec"])[0] < 1e-3


def test_support_minibatch_draws_without_replacement():
    """``adapt.imaml.batch_size``: a subset without repeats per draw, a
    hypergradient that differs from the full support's, and the full
    support exactly where the size is unset or at least K."""
    system, quad = _quad_system(steps=6, cg_steps=5, lr=0.1, batch_size=2)
    sup, qry = _quad_episode(seed=2)
    rows = {tuple(r.tolist()) for r in sup.mels.reshape(3, -1)}
    draws = [system._support_minibatch(sup, s) for s in range(20)]
    for d in draws:
        got = [tuple(r.tolist()) for r in d.mels.reshape(2, -1)]
        assert len(set(got)) == 2 and set(got) <= rows
    assert len({tuple(d.mels.sum((1, 2)).tolist()) for d in draws}) > 1
    h_mini, _ = system._episode_hypergrad(quad.init_params, sup, qry, 11)
    full, _ = _quad_system(steps=6, cg_steps=5, lr=0.1)
    h_full, _ = full._episode_hypergrad(quad.init_params, sup, qry, 11)
    assert all(torch.isfinite(v).all() for v in h_mini.values())
    assert float((h_mini["enc"] - h_full["enc"]).norm()) > 1e-6
    degen, _ = _quad_system(steps=6, cg_steps=5, lr=0.1, batch_size=8)
    h_degen, _ = degen._episode_hypergrad(quad.init_params, sup, qry, 11)
    for k in h_full:
        assert torch.equal(h_degen[k], h_full[k]), k
