"""Few-shot adaptation machinery (MAML-style inner loops).

Parameters are a dict of named tensors of one ``FastSpeech2``; a forward on
any such dict runs through ``torch.func.functional_call``, so the inner
loop's fast weights need no module copies.

* ``partition``/``merge`` select the adapted parameters by top-level module
  (``algorithm.adapt.modules``, reference ``base_adaptor.py:31-35``).
* The inner loop is plain SGD on the support loss.  Second order (training)
  runs either as ``custom_hvp`` (default: each step is an autograd Function
  whose backward is one Hessian-vector product) or ``unrolled`` (autograd
  through the unrolled steps); first order (validation, test) detaches the
  inner gradients.
* BatchNorm running statistics are never written here: the support and
  query forwards normalise with batch statistics in training, as the JAX
  package's frozen state does.
* ``adapt`` runs under ``flags.step_flags``, so that it repeats itself on
  the card.
"""

import torch
from torch.autograd.function import once_differentiable
from torch.func import functional_call

from ..models import nn as L
from ..models.loss import fastspeech2_loss
from ..models.phoneme_embedding import get_new_embedding
from .flags import repeatable


def partition(params, modules):
    """Split a name -> tensor dict into (adapted, frozen) by top-level module."""
    adapted = {k: v for k, v in params.items() if k.split(".")[0] in modules}
    frozen = {k: v for k, v in params.items() if k.split(".")[0] not in modules}
    return adapted, frozen


def merge(adapted, frozen):
    return {**adapted, **frozen}


class _Step:
    """What one custom-HVP SGD step needs besides its tensors."""

    def __init__(self, adaptor, names_a, names_f, lr, sup, train, seed,
                 fast_impl, exact_impl, hvp_mode):
        self.adaptor, self.names_a, self.names_f = adaptor, names_a, names_f
        self.lr, self.sup, self.train, self.seed = lr, sup, train, seed
        self.fast_impl, self.exact_impl = fast_impl, exact_impl
        self.hvp_mode = hvp_mode

    def loss(self, a, f, impl):
        # the same seed in the forward and in the HVP: the same dropout masks
        return self.adaptor._support_loss(
            dict(zip(self.names_a, a)), dict(zip(self.names_f, f)), self.sup,
            self.train, self.seed, impl)

    def hvp_rev(self, a, f, u):
        """(H_aa u, H_fa u) as the gradient of grad_a L . u (reverse over
        reverse); None where a tensor gets no gradient."""
        with torch.enable_grad():
            a_d = [t.detach().requires_grad_() for t in a]
            f_d = [t.detach().requires_grad_() for t in f]
            loss = self.loss(a_d, f_d, self.exact_impl)
            g = torch.autograd.grad(loss, a_d, create_graph=True, allow_unused=True)
            g_dot_u = sum((gi * ui).sum() for gi, ui in zip(g, u)
                          if gi is not None and gi.requires_grad)
            h = torch.autograd.grad(g_dot_u, a_d + f_d, allow_unused=True)
        return h[:len(a)], h[len(a):]

    def hvp_fwd(self, a, f, u):
        """(H_aa u, H_fa u) as one forward-mode JVP of the full gradient
        grad_{a,f} L in the direction (u, 0) (forward over reverse: by the
        symmetry of mixed partials, the pair ``hvp_rev`` computes)."""
        # torch.utils.checkpoint carries no tangents through torch.func's
        # transforms; plain einsum is the same function without the recompute
        impl = "einsum" if self.exact_impl == "einsum_remat" else self.exact_impl
        grad = torch.func.grad(
            lambda a_, f_: self.loss(list(a_), list(f_), impl), argnums=(0, 1))
        a, f = tuple(t.detach() for t in a), tuple(t.detach() for t in f)
        _, (h_a, h_f) = torch.func.jvp(
            grad, (a, f), (tuple(u), tuple(torch.zeros_like(t) for t in f)))
        return h_a, h_f


class _HVPStep(torch.autograd.Function):
    """One inner SGD step ``a' = a - lr * grad_a L(a, f)`` with a
    hand-written second-order rule (the JAX package's ``make_hvp_sgd_step``).

    forward:  the gradient on ``fast_impl`` attention (once differentiated,
              inside this operator);
    backward: the exact step Jacobian VJP ``da = u - lr * H_aa u``,
              ``df = -lr * H_fa u`` from ONE Hessian-vector product,
              recomputed from the saved step inputs on ``exact_impl``
              attention, with the forward's dropout masks replayed; reverse
              over reverse (``hvp_mode="rev"``) or forward over reverse
              (``"fwd"``).
    """

    @staticmethod
    def forward(ctx, step, *tensors):
        n = len(step.names_a)
        a, f = tensors[:n], tensors[n:]
        with torch.enable_grad():
            a_d = [t.detach().requires_grad_() for t in a]
            loss = step.loss(a_d, [t.detach() for t in f], step.fast_impl)
            g = torch.autograd.grad(loss, a_d, allow_unused=True)
        ctx.step = step
        ctx.save_for_backward(*tensors)
        return tuple(t.clone() if gi is None else t - step.lr * gi
                     for t, gi in zip(a, g))

    @staticmethod
    @once_differentiable
    def backward(ctx, *u):
        step = ctx.step
        tensors = ctx.saved_tensors
        n = len(step.names_a)
        hvp = step.hvp_fwd if step.hvp_mode == "fwd" else step.hvp_rev
        h_a, h_f = hvp(tensors[:n], tensors[n:], u)
        da = [ui if hi is None else ui - step.lr * hi for ui, hi in zip(u, h_a)]
        df = [None if hi is None else -step.lr * hi for hi in h_f]
        return (None, *da, *df)


class Adaptor:
    """Episode functions over one model: forward on a parameter dict, the
    loss, the inner loop and the meta step's episode loss."""

    def __init__(self, model, preprocess_cfg, model_cfg, algorithm_cfg):
        self.model = model
        self.pcfg = preprocess_cfg
        self.mcfg = model_cfg
        self.acfg = algorithm_cfg
        self.modules = tuple(algorithm_cfg["adapt"]["modules"])

    # ---------------------------------------------------------- forward

    def forward(self, params, batch, *, train=False, seed=None,
                attention_impl=None, average_spk_emb=False,
                teacher_forced=None, max_mel_len=None, fused_infer=None,
                update_bn_state=False):
        """The model's forward on ``params`` (name -> tensor); BatchNorm
        running statistics stay as they are unless ``update_bn_state``
        (the baseline step keeps the JAX forward's new state).
        ``teacher_forced``, ``max_mel_len`` and ``fused_infer`` pass through
        to ``FastSpeech2.forward`` (the JAX package passes the last as a
        model config override, ``_fused_infer``)."""
        return functional_call(self.model, params, (batch,), dict(
            train=train, seed=seed, attention_impl=attention_impl,
            update_bn_state=update_bn_state, average_spk_emb=average_spk_emb,
            teacher_forced=teacher_forced, max_mel_len=max_mel_len,
            fused_infer=fused_infer))

    def loss(self, batch, output):
        return fastspeech2_loss(batch, output, self.pcfg)

    # ------------------------------------------------------- inner loop

    def _support_loss(self, adapted, frozen, sup, train, seed,
                      attention_impl=None):
        out = self.forward(merge(adapted, frozen), sup, train=train,
                           seed=seed, attention_impl=attention_impl)
        return self.loss(sup, out).total

    @repeatable
    def adapt(self, params, sup, *, steps, lr, first_order, train, seed=None):
        """Inner-loop SGD on the adapted parameters; returns the merged
        dict.  Step i draws its dropout from seed ``split(seed, steps)[i]``.

        Second order (``model.second_order_impl``): "custom_hvp" runs the
        forward gradient on ``model.fast_attention_impl`` and the HVP on
        ``model.inner_attention_impl`` (both default "einsum_remat"), the
        HVP reverse over reverse or, with ``model.hvp_mode="fwd"``, forward
        over reverse; any other value unrolls the steps on
        ``inner_attention_impl``, since the flash kernel is differentiable
        once only.  First order runs the config's attention (flash on the
        card)."""
        adapted, frozen = partition(params, self.modules)
        so_impl = self.mcfg.get("second_order_impl", "custom_hvp")
        inner_impl = self.mcfg.get("inner_attention_impl", "einsum_remat")
        seeds = L.split(seed, steps)
        if not first_order and so_impl == "custom_hvp":
            fast_impl = self.mcfg.get("fast_attention_impl", "einsum_remat")
            hvp_mode = self.mcfg.get("hvp_mode", "rev")
            if hvp_mode not in ("rev", "fwd"):
                raise ValueError(f"hvp_mode {hvp_mode!r}: expected rev | fwd")
            names_a, names_f = list(adapted), list(frozen)
            for s in seeds:
                step = _Step(self, names_a, names_f, lr, sup, train, s,
                             fast_impl, inner_impl, hvp_mode)
                out = _HVPStep.apply(step, *adapted.values(), *frozen.values())
                adapted = dict(zip(names_a, out))
            return merge(adapted, frozen)
        impl = None if first_order else inner_impl
        for s in seeds:
            loss = self._support_loss(adapted, frozen, sup, train, s, impl)
            g = torch.autograd.grad(loss, list(adapted.values()),
                                    create_graph=not first_order,
                                    allow_unused=True)
            adapted = {k: v if gi is None else v - lr * gi
                       for (k, v), gi in zip(adapted.items(), g)}
        return merge(adapted, frozen)

    def adapt_first_order(self, params, sup, *, steps, lr, train, seed=None):
        """First-order ``adapt`` of detached copies of ``params`` (only the
        adapted modules' tensors take gradients, so no backward runs
        through the frozen ones); returns detached tensors."""
        params = {k: v.detach().requires_grad_(k.split(".")[0] in self.modules)
                  for k, v in params.items()}
        with torch.enable_grad():
            out = self.adapt(params, sup, steps=steps, lr=lr, first_order=True,
                             train=train, seed=seed)
        return {k: v.detach() for k, v in out.items()}

    # ------------------------------------------- cross-lingual codebook

    def refresh_phoneme_table(self, params, phn_ref):
        """``params`` with ``encoder.src_word_emb.weight`` replaced by the
        table the codebook (``phn_emb_generator.*`` of ``params``) makes
        from the support set's per-phoneme representations ``phn_ref``
        (vocab, d_feat) (reference ``meta.py:24-33``): a tensor with a graph
        back to the codebook, so the outer loop meta-learns it."""
        att = self.acfg["adapt"]["phoneme_emb"].get("attention", {"type": "hard"})["type"]
        pre = "phn_emb_generator."
        codebook = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
        table = get_new_embedding(codebook, phn_ref, att)
        return {**params, "encoder.src_word_emb.weight": table}

    # -------------------------------------------------------- meta step

    def meta_learn(self, params, sup, qry, *, steps, lr, train, seed=None,
                   phn_ref=None):
        """Adapt on the support set, evaluate on the query set (reference
        ``base_adaptor.py:114-124``).  Returns (LossValues, FS2Output).
        Second order when training, first order otherwise.  The query
        forward teacher-forces and conditions on the averaged support
        speaker embedding.  With ``phn_ref`` the phoneme table is first
        regenerated from it (``refresh_phoneme_table``)."""
        r_adapt, r_qry = L.split(seed, 2)
        if phn_ref is not None:
            params = self.refresh_phoneme_table(params, phn_ref)
        adapted = self.adapt(params, sup, steps=steps, lr=lr,
                             first_order=not train, train=train, seed=r_adapt)
        qry = qry._replace(speaker_args=episode_speaker_args(
            sup.speaker_args, qry.speaker_args))
        out = self.forward(adapted, qry, train=train, seed=r_qry,
                           average_spk_emb=True)
        return self.loss(qry, out), out


def episode_speaker_args(sup_args, qry_args):
    """The query conditions on the support speakers (1-way tasks): the
    first support id, broadcast to the query count; in the d-vector modes
    the support's reference slices themselves (the query averages their
    embeddings)."""
    if isinstance(sup_args, tuple):
        return sup_args
    return sup_args[:1].expand(qry_args.shape[0])
