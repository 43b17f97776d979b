"""Seeds, weights and inputs, made from ``--seed`` on the run's device.

Weights are He-normal (the standard deviation sqrt(2 / fan in), the fan in
being the inputs an output value sums: Cin x taps for a conv, Cin for a
transposed conv whose kernel equals its stride) with biases uniform in
[-0.1, 0.1), drawn in two calls from one ``torch.Generator`` on the card.
The same seed gives the same weights and inputs; the benchmark hands them
to the program and to the plain reference alike.
"""

import math
import zlib

import torch

_MASK = 2 ** 63 - 1


def sub_seed(seed, tag, i=0):
    """A 63-bit seed for the stream ``tag`` (and index ``i``) of run seed
    ``seed``, any whole number."""
    h = zlib.crc32(f"{tag}:{i}".encode())
    return (int(seed) * 0x9E3779B97F4A7C15 + h * 0x632BE59BD9B4E019) & _MASK


def generator(seed, tag, device, i=0):
    return torch.Generator(device).manual_seed(sub_seed(seed, tag, i))


def param_shapes(net):
    """``[(node, w shape, fan in)]`` of every weighted node, in graph
    order."""
    ch = net.channels()
    out = []
    for n in net.nodes:
        if n["op"] == "conv":
            cin = ch[net.parents(n)[0]["name"]]
            out.append((n["name"], (n["n_f"], cin, *n["filter"]),
                        cin * math.prod(n["filter"])))
        elif n["op"] == "upconv":
            cin = ch[net.parents(n)[0]["name"]]
            out.append((n["name"], (n["n_f"], cin, *n["pool"]), cin))
    return out


def make_params(net, seed, device):
    """``{node: {"w", "b"}}`` float32 tensors on ``device`` from ``seed``."""
    shapes = param_shapes(net)
    gen = generator(seed, "weights", device)
    nw = sum(math.prod(s) for _, s, _ in shapes)
    nb = sum(s[0] for _, s, _ in shapes)
    w_all = torch.randn(nw, generator=gen, device=device)
    b_all = torch.rand(nb, generator=gen, device=device) * 0.2 - 0.1
    params, iw, ib = {}, 0, 0
    for name, s, fan_in in shapes:
        k = math.prod(s)
        w = w_all[iw:iw + k].reshape(s) * math.sqrt(2.0 / fan_in)
        params[name] = {"w": w.contiguous(),
                        "b": b_all[ib:ib + s[0]].clone()}
        iw, ib = iw + k, ib + s[0]
    return params


def uniform_volume(seed, tag, i, shape, device):
    """A float32 volume uniform in [0, 1) from ``seed``."""
    return torch.rand(tuple(shape), generator=generator(seed, tag, device, i),
                      device=device)
