"""The reference's left-padded prefill fault, measured on both packages:
the Zamba2 and xLSTM smoke configs in f32, the reference's init weights
(carried into the port with ``repro_torch.convert``), with the biases
that leak through the pads perturbed by 0.3 N(0, 1) from a seeded
generator.  A 10-token prompt is prefilled left-padded to a width, and
each package's logprobs at the prompt's positions are compared with its
own forward on the unpadded prompt.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/left_pad_fault.py

prints the max |d logprob| of each package at widths 10, 16 and 32 for
each perturbation (and at the init, all biases zero).
``tests/test_torch_recurrent.py`` builds its models here and holds the
same measurements to its limits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_smoke_config as jget_smoke
from repro.models.model import build_model as jbuild
from repro_torch import convert
from repro_torch.configs.base import get_smoke_config
from repro_torch.models.model import build_model

ZAMBA, XLSTM = "zamba2_1_2b", "xlstm_125m"
# (model, biases perturbed): Zamba2's two conv biases, xLSTM's input
# layernorm biases (both blocks' ``ln``) or its sLSTM gate biases
CASES = [("zamba2", "conv"), ("xlstm", "ln"), ("xlstm", "b_gates")]
_CACHE = {}


def cfgs(name):
    """(reference, port) f32 configs: a smoke config, or Zamba2's with a
    third layer (``zamba2_tail``: a group of two layers and the shared
    block, then a tail layer)."""
    arch = XLSTM if name == "xlstm" else ZAMBA
    j = jget_smoke(arch).replace(param_dtype=jnp.float32,
                                 compute_dtype=jnp.float32)
    t = get_smoke_config(arch).replace(param_dtype=torch.float32,
                                       compute_dtype=torch.float32)
    if name == "zamba2_tail":
        j, t = j.replace(num_layers=3), t.replace(num_layers=3)
    return j, t


def models(name):
    """(reference model, its params, port model, the same params)."""
    if name not in _CACHE:
        jcfg, tcfg = cfgs(name)
        jm = jbuild(jcfg)
        jp = jm.init_params(jax.random.PRNGKey(1))
        tm = build_model(tcfg, device="cpu")
        tp = convert.from_jax_params(jax.tree.map(np.asarray, jp),
                                     device="cpu")
        _CACHE[name] = (jm, jp, tm, tp)
    return _CACHE[name]


def perturbed(name, which, seed=0):
    """``models(name)`` with the biases of ``which`` perturbed (None: as
    initialised) in both packages' trees."""
    jm, jp, tm, _ = models(name)
    p = jax.tree.map(np.array, jp)
    rng = np.random.RandomState(seed)

    def add(tree, key):
        tree[key] = (tree[key] + 0.3 * rng.randn(*tree[key].shape)).astype(
            tree[key].dtype)
    if which == "conv":
        add(p["mamba_main"], "conv_x_b")
        add(p["mamba_main"], "conv_bc_b")
    elif which == "ln":
        add(p["mlstm"]["ln"], "bias")
        add(p["slstm"]["ln"], "bias")
    elif which == "b_gates":
        add(p["slstm"], "b_gates")
    return jm, p, tm, convert.from_jax_params(p, device="cpu")


def left_padded(prompts, width):
    toks = np.zeros((len(prompts), width), np.int32)
    for i, p in enumerate(prompts):
        toks[i, width - len(p):] = p
    return toks, np.asarray([len(p) for p in prompts], np.int32)


def prompt(vocab, n=10):
    return np.random.RandomState(3).randint(1, vocab, n)


def gaps(jm, jp, tm, tp, prompt, width, max_len=32):
    """(reference gap, port gap, port cache): each package's max |d
    logprob| over the prompt's positions between its prefill left-padded
    to ``width`` and its forward on the unpadded prompt."""
    n = len(prompt)
    jf = jax.nn.log_softmax(jm.forward(jp, {"tokens": jnp.asarray(
        prompt[None])})[0][0], -1)
    tf = torch.log_softmax(tm.forward(tp, {"tokens": torch.from_numpy(
        prompt[None].astype(np.int32))})[0][0], -1)
    toks, plens = left_padded([prompt.tolist()], width)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                            "prompt_lens": jnp.asarray(plens)},
                       jm.init_cache(1, max_len))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "prompt_lens": torch.from_numpy(plens)},
                        tm.init_cache(1, max_len))
    j_gap = float(jnp.abs(jax.nn.log_softmax(jl[0, width - n:], -1)
                          - jf).max())
    t_gap = float((torch.log_softmax(tl[0, width - n:], -1) - tf).abs().max())
    return j_gap, t_gap, tc


def main():
    print("model   biases   width  reference  port")
    for name, which in [("zamba2", None), ("xlstm", None)] + CASES:
        jm, jp, tm, tp = perturbed(name, which)
        p = prompt(jm.cfg.vocab_size)
        for width in (10, 16, 32):
            j_gap, t_gap, _ = gaps(jm, jp, tm, tp, p, width)
            print(f"{name:7s} {which or 'init':8s} {width:5d}  "
                  f"{j_gap:9.3g}  {t_gap:.3g}")


if __name__ == "__main__":
    main()
