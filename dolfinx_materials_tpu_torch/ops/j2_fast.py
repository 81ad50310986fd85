"""Batched J2 radial return with the analytic consistent tangent, no AD.

One pass over the batch: fixed-iteration masked Newton on the scalar plastic
multiplier and the closed-form Simo-Hughes tangent

    C_ep = C - 2 mu beta K4 - gamma nbar (x) nbar,
    beta = 3 mu dp / q_tr,   gamma = 9 mu^2 (1/(3 mu + H') - dp / q_tr).

On CUDA tensors this launches the J2 kernel (ops/j2_cuda.py) with the j2_fast
contract: cold start, ``n_iter`` = 12, regularizer ``(1e-14 (1 + sigY))^2``,
so the card computes what the JAX package's main path computes. Written out
as plain torch it would be some fifty small launches per call. On CPU tensors
the kernel's plain version runs the same contract.
"""

from __future__ import annotations

from .j2_cuda import J2_FAST_CONTRACT, J2Launch


def make_j2_batched_update(elasticity, yield_stress, n_iter=12):
    """Returns ``batched(eps (n,6), state {eps_p (n,6), p (n,)}, dt) ->
    (sig (n,6), Ct_flat (n,36), new_state)``.

    The four hardening laws of models/hardening.py run inside the kernel in
    closed form; any other traceable callable runs inside it as a law program
    (ops/law_program.py), traced here once. A law that is not a program
    raises ``TypeError`` on CUDA tensors (on CPU tensors the plain version
    takes any callable). The kernel's launch (:class:`~.j2_cuda.J2Launch`,
    ``batched.launch``) is built here, once: the parameters are those of
    ``elasticity`` and ``yield_stress`` now.
    """
    launch = J2Launch(elasticity, yield_stress, factored=False,
                      **dict(J2_FAST_CONTRACT, n_iter=n_iter))

    def batched(eps, state, dt):
        sig, Ct, eps_p, p = launch(
            eps.contiguous(), state["eps_p"].contiguous(), state["p"].contiguous(),
            feature_major=False,
        )
        return sig, Ct, {"eps_p": eps_p, "p": p}

    batched.launch = launch
    return batched
