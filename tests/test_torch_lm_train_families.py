"""The port's LM training of the non-dense families against the JAX
package, on the CPU.

The reduced qwen3-moe-30b-a3b and arctic-480b (MoE dispatch and combine,
arctic with its dense residual), mamba2-1.3b (the SSD chunk scan),
recurrentgemma-9b at 5 layers (the RG-LRU scan, local attention and the
two rglru tail blocks), seamless-m4t-medium (the encoder and
cross-attention) and qwen2-vl-72b (M-RoPE streams and patch
``embeds``), each with several attention chunks: 3 steps of the
launcher's AdamW on the launcher's batches against the reference's
jitted step, the loss each step, both moments of every leaf after the
last and the loss the final parameters give on a fourth batch within the
reference's cross-program tolerance (``rtol=1e-4, atol=1e-5``), from
the JAX ``init_params`` output carried across with
``params_from_numpy``. Within the port: two fresh runs bit-equal on two
intra-op threads, and the ``--workload lm`` launcher of the MoE, SSD
and RG-LRU families (the enc-dec and M-RoPE ones:
``test_torch_encdec_vlm.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_reduced as j_get_reduced
from repro.data.pipeline import synthetic_lm_batches as j_batches
from repro.models.transformer import init_params as j_init
from repro.models.transformer.model import lm_loss as j_lm_loss
from repro.train import AdamW as JAdamW
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import synthetic_lm_batches
from repro_torch.graph.sampler import rng_from
from repro_torch.kernels.flash_attention import ops as t_fa_ops
from repro_torch.kernels.flash_decode import ops as t_fd_ops
from repro_torch.models.transformer import (init_params, lm_loss,
                                            make_train_step,
                                            params_from_numpy)
from repro_torch.train import AdamW
from repro_torch.train.optim import tree_leaves
import _torch_threads  # noqa: F401  (torch's threads capped in a worker)

TOL = dict(rtol=1e-4, atol=1e-5)
ADAMW = dict(lr=3e-4, weight_decay=0.01, max_grad_norm=1.0)
#: several q and kv chunks at S = 32 (the chunked path needs S a
#: multiple of each; the encoder's source is as long as the target)
CHUNKS = dict(attn_q_chunk=8, attn_kv_chunk=16)
#: name -> config fields set on both packages' reduced configs
FAMILIES = {
    "qwen3-moe-30b-a3b": {},
    "arctic-480b": {},
    "mamba2-1.3b": {},
    # one (rglru, rglru, local) repeat and the two rglru tail blocks
    "recurrentgemma-9b": {"num_layers": 5},
    "seamless-m4t-medium": {},
    "qwen2-vl-72b": {},
}
B, S, STEPS = 2, 32, 3


def _cfgs(name):
    kw = {**FAMILIES[name], **CHUNKS}
    return (dataclasses.replace(get_reduced(name), **kw),
            dataclasses.replace(j_get_reduced(name), **kw))


def _jparams(jcfg, seed):
    """The reference's initial parameters with every zero-initialised
    leaf (norm scales, biases) filled from a seed too."""
    rng = rng_from(seed, 1)

    def fill(a):
        a = np.asarray(a)
        if not np.any(a):
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(fill, j_init(jcfg, jax.random.key(seed)))


def _paths(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_adamw_steps_match_reference(name):
    """Each step's loss, both moments of every leaf after the last step,
    and the loss the final parameters give on a fourth batch, against the
    reference's jitted ``value_and_grad(lm_loss)`` and AdamW (moments,
    clipped update, weight decay) on the same batches (the frontends'
    stub embeddings and M-RoPE streams included); no kernel launched on
    the gradient path. The parameters are held through that loss, not
    leaf by leaf: AdamW divides each moment by its root, so a gradient
    element that is float32 noise moves its parameter by a different
    fraction of ``lr`` in each package (1 element of 131,072 in arctic's
    first ``wq`` by 2.9e-5 after 3 steps)."""
    cfg, jcfg = _cfgs(name)
    jp = _jparams(jcfg, 21)
    tp = params_from_numpy(jp)
    jopt, opt = JAdamW(**ADAMW), AdamW(**ADAMW)

    @jax.jit
    def jstep(p, o, b):
        (loss, _), g = jax.value_and_grad(
            lambda pp: j_lm_loss(jcfg, pp, b), has_aux=True)(p)
        return (*jopt.update(g, o, p), loss)

    step = make_train_step(cfg, opt)
    jo, to = jopt.init(jp), opt.init(tp)
    batches = list(zip(
        j_batches(jcfg, batch=B, seq=S, steps=STEPS + 1, s0=9),
        synthetic_lm_batches(cfg, batch=B, seq=S, steps=STEPS + 1, s0=9)))
    launched = (t_fa_ops.LAUNCHES.value, t_fd_ops.LAUNCHES.value)
    for jb, tb in batches[:STEPS]:
        assert sorted(jb) == sorted(tb)
        jp, jo, jloss = jstep(jp, jo, jb)
        tp, to, aux = step(tp, to, tb)
        np.testing.assert_allclose(aux["loss"].item(), float(jloss), **TOL)
    assert (t_fa_ops.LAUNCHES.value, t_fd_ops.LAUNCHES.value) == launched
    assert int(to.step) == int(jo.step) == STEPS
    for t, j in ((to.mu, jo.mu), (to.nu, jo.nu)):
        got = _paths(jax.tree.map(lambda x: x.numpy(), t))
        want = _paths(j)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), **TOL,
                                       err_msg=jax.tree_util.keystr(path))
    jb, tb = batches[STEPS]
    with torch.no_grad():
        np.testing.assert_allclose(lm_loss(cfg, tp, tb)[0].item(),
                                   float(j_lm_loss(jcfg, jp, jb)[0]), **TOL)


def _train(cfg, seed=0):
    """The launcher's run at 4 x 64 (Zipf tokens: repeated rows in the
    embedding's backward, repeated experts in the MoE's)."""
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    opt = AdamW(**ADAMW)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    losses = []
    for batch in synthetic_lm_batches(cfg, batch=4, seq=64, steps=STEPS,
                                      s0=seed):
        params, state, aux = step(params, state, batch)
        losses.append(aux["loss"].item())
    return losses, params


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_two_fresh_runs_bit_equal(name):
    """On two intra-op threads, so that a backward whose sums depend on
    the threads' order would show."""
    cfg = _cfgs(name)[0]
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        a_losses, a_params = _train(cfg)
        b_losses, b_params = _train(cfg)
    finally:
        torch.set_num_threads(threads)
    assert a_losses == b_losses and all(np.isfinite(a_losses))
    for a, b in zip(tree_leaves(a_params), tree_leaves(b_params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "arctic-480b",
                                  "mamba2-1.3b", "recurrentgemma-9b"])
def test_lm_launcher_trains_on_cpu(name, capsys):
    """12 steps: mamba2-1.3b's loss at 8 x 32 is above its first at step
    8 and below it from step 9."""
    from repro_torch.launch.train import main
    main(["--workload", "lm", "--device", "cpu", "--arch", name,
          "--steps", "12", "--seq", "32"])
    out = capsys.readouterr().out
    assert f"== lm {name} (reduced) on cpu == 12 steps" in out
    first, last = (float(x) for x in out.split("loss ")[-1].split(" -> "))
    assert last < first
