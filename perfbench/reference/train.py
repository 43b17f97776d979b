"""The plain reference of a training chunk: the batches re-derived from the
cubes and the seed (``augment.Augment``), the net's valid-mode forward
(``nets.Reference``), the sparse multinoulli NLL averaged over voxels and
batch, its gradients by ``torch.autograd``, and Adam with bias correction
and a global-norm clip, all float32 with TF32 off. It starts from the
weights the benchmark handed the program and returns what the output
check compares: each step's loss, Adam's first moment after the chunk and
the parameters' change over it.
"""

import torch

from .augment import Augment
from .nets import Reference

EPS = 1e-10       # the NLL's floor under a probability


def nll(probs, target):
    logp = torch.log(torch.clamp(probs, min=EPS))
    return -torch.gather(logp, 1, target.long()[:, None]).mean()


def adam_step(params, grads, m, v, t, hyper):
    """One in-place Adam step of the lists ``params`` with ``grads``;
    ``t`` is the step number (from 1)."""
    b1, b2 = hyper["beta1"], hyper["beta2"]
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads)
                       + 1e-12)
    clip = hyper["clip"]
    scale = torch.clamp(clip / gnorm, max=1.0) if clip > 0 else 1.0
    tt = torch.tensor(float(t), device=gnorm.device)
    for p, g, mi, vi in zip(params, grads, m, v):
        g = g * scale
        mi.mul_(b1).add_((1 - b1) * g)
        vi.mul_(b2).add_((1 - b2) * torch.square(g))
        m_hat = mi / (1 - torch.pow(torch.tensor(b1, device=tt.device), tt))
        v_hat = vi / (1 - torch.pow(torch.tensor(b2, device=tt.device), tt))
        p.sub_(hyper["lr"] * m_hat / (torch.sqrt(v_hat) + hyper["eps"]))


def train_chunk(net, params0, raws, labels, gen, steps, B, train, traffic,
                control=False, fault=None, dtype=torch.float32):
    """``steps`` steps from ``params0`` (``{node: {"w", "b"}}``, left
    untouched) on batches drawn from ``gen``. Returns (losses (steps,),
    params after, Adam's first moment after), the trees keyed like
    ``params0``. ``fault`` plants a fault for the checks' own tests:
    ``"frozen"`` (the step returns its state unchanged) or ``"half_batch"``
    (the loss is the mean over half of the batch). ``dtype`` float64 runs
    the net and Adam in float64 on the same (float32) batches: the witness
    of how far float32 rounding alone carries the chunk."""
    names = [(n, k) for n in sorted(params0) for k in sorted(params0[n])]
    params = {n: {k: v.detach().to(dtype).clone() for k, v in d.items()}
              for n, d in params0.items()}
    leaves = [params[n][k] for n, k in names]
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    hyper = {"lr": train["lr"], "beta1": 0.9, "beta2": 0.999, "eps": 1e-8,
             "clip": train.get("clip", 0.0)}
    aug = Augment(raws, labels, train["patch"],
                  net.valid_shapes(train["patch"])[net.output["name"]],
                  net.strides[net.output["name"]], traffic["warp_amount"],
                  traffic["grey_channels"])
    ref = Reference(net, params, control=control)
    losses = []
    for t in range(1, steps + 1):
        data, tgt = aug.batch(gen, B, traffic["warp_prob"])
        data = data.to(dtype)
        if fault == "half_batch":
            data, tgt = data[:B // 2], tgt[:B // 2]
        for p in leaves:
            p.requires_grad_(True)
        loss = nll(ref.valid(data), tgt)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for p in leaves:
                p.requires_grad_(False)
            if fault != "frozen":
                adam_step(leaves, grads, m, v, t, hyper)
    first = {}
    for (n, k), mi in zip(names, m):
        first.setdefault(n, {})[k] = mi
    return losses, params, first
