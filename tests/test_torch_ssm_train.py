"""PyTorch port: the ssm and hybrid families' training held to the JAX
package on the CPU.

Reduced falcon-mamba-7b (2 mamba1 layers) and zamba2-1.2b (1 mamba2 layer
and the shared attention + MLP block; 3 layers for the loss), the same
parameters and batches in both packages: ``loss_fn`` and every leaf's
gradient against ``jax.value_and_grad(lm.loss_fn)``; the remat settings
against each other and JAX's ``ssm_chunk`` against the port's fixed scan
checkpoints; one ``build_train_step`` Adam step
against JAX's; ``launch/train.py`` on the CPU.  The JAX gradients are
computed once a configuration (module fixtures): they are the slow part.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as j_get_config
from repro.models import lm as jlm
from repro.models.lm import ModelKnobs as JModelKnobs
from repro.optim import make_optimizer as j_make_optimizer
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.tree import flatten
from repro_torch.launch import train as launch_train
from repro_torch.models import lm
from repro_torch.models.convert import (train_state_from_numpy,
                                        train_state_to_numpy)
from repro_torch.models.lm import ModelKnobs
from repro_torch.ps.stepfn import StepKnobs, build_train_step

from test_torch_train_step import (GRAD_RTOL, LOSS_TOL, _port_grads,
                                   _tree_np, assert_leaves_close)

B, S = 2, 32


def _models(arch, seed, **overrides):
    """(jax cfg, port cfg, jax params, port params on the CPU) of a reduced
    config: the port's seeded parameters, the same bf16 values handed to
    the JAX package (its own ``init_params`` takes ~8 s here; the
    distributions are the same)."""
    tcfg = get_config(arch).reduced(**overrides)
    tp = lm.init_params(tcfg, seed, device="cpu")
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                train_state_to_numpy(tp))
    return j_get_config(arch).reduced(**overrides), tcfg, jp, tp


def ssm_models(seed):
    return _models("falcon-mamba-7b", seed)


def hybrid_models(seed, n_layers):
    return _models("zamba2-1.2b", seed, n_layers=n_layers)

# The reduced hybrid is held leaf by leaf at 1 layer (the shared block
# applied once; JAX against the port at most 2.84% there, the port's own
# one-step noise floor 2.37%).  Deeper, its gradients are chaotic in bf16:
# at 3 layers moving every attention output by one bf16 step moves the
# port's own gradients by up to 25.8% of a leaf's largest value, and JAX's
# differ from the port's by up to 57.1% (embed/tokens), its roundings
# differing at many such sites (scripts/grad_gap_cpu.py --family hybrid
# --layers 1 and 3 --noise, 4 seeds x 3 batch shapes; reduced
# falcon-mamba: 2.31%, floor 2.79%), so at 3 layers the loss is held
# (gap at most 0.0027) and every gradient must be finite and nonzero.
MODELS = {"ssm": lambda: ssm_models(0),
          "hybrid": lambda: hybrid_models(0, n_layers=1)}


def _batch(seed):
    rng = np.random.default_rng(seed)
    toks, labels = rng.integers(0, 256, (2, B, S))
    return ({"tokens": jnp.asarray(toks, jnp.int32),
             "labels": jnp.asarray(labels, jnp.int32)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


@pytest.fixture(scope="module", params=list(MODELS))
def ref(request):
    """(name, jax cfg, port cfg, jax params, port params, batches, JAX loss
    and gradients) of one configuration."""
    cfg, tcfg, jp, tp = MODELS[request.param]()
    jb, tb = _batch(1)
    (jl, _), jg = jax.jit(jax.value_and_grad(jlm.loss_fn, has_aux=True),
                          static_argnums=(2, 3, 4))(jp, jb, cfg, None,
                                                    JModelKnobs())
    return request.param, cfg, tcfg, jp, tp, tb, float(jl), _tree_np(jg)


def test_loss_and_grads_match_jax(ref):
    _, _, tcfg, _, tp, tb, jl, jg = ref
    tl, tg = _port_grads(tp, tcfg, tb, ModelKnobs())
    assert abs(jl - float(tl.detach())) <= LOSS_TOL
    assert_leaves_close(jg, tg, GRAD_RTOL, "grad")


def test_deeper_hybrid_loss_matches_jax_and_reaches_every_leaf():
    """The reduced hybrid at 3 layers (the shared block after layers 0 and
    2): the loss within LOSS_TOL of JAX's, and every leaf's gradient finite
    and nonzero, the shared block's from both of its applications."""
    cfg, tcfg, jp, tp = hybrid_models(2, n_layers=3)
    jb, tb = _batch(2)
    jl, _ = jax.jit(jlm.loss_fn, static_argnums=(2, 3, 4))(
        jp, jb, cfg, None, JModelKnobs())
    tl, tg = _port_grads(tp, tcfg, tb, ModelKnobs())
    assert abs(float(jl) - float(tl.detach())) <= LOSS_TOL
    for p, g in zip(*flatten(tg)):
        assert torch.isfinite(g.float()).all() and g.abs().max() > 0, p


def test_ssm_chunk_and_remat_give_the_same_gradients(ref):
    """What is kept for the backward does not change the arithmetic.  The
    port's ``remat`` dots and full (``SelectiveScan`` runs again in the
    backward) give the same loss and gradients, bit for bit.  The port's
    scan keeps its state every ``CHK_STEPS`` steps and has no
    ``ssm_chunk`` knob; the JAX package's ``ssm_chunk`` 8 (two
    checkpointed intervals) gives the port's loss within LOSS_TOL.  On 16
    positions of the batch."""
    _, cfg, tcfg, jp, tp, tb, _, _ = ref
    tb = {k: v[:, :16] for k, v in tb.items()}
    base_loss, base = _port_grads(tp, tcfg, tb, ModelKnobs())
    jb = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in tb.items()}
    jl, _ = jax.jit(jlm.loss_fn, static_argnums=(2, 3, 4))(
        jp, jb, cfg, None, JModelKnobs(ssm_chunk=8))
    assert abs(float(jl) - float(base_loss.detach())) <= LOSS_TOL
    for knobs in (ModelKnobs(remat="dots"), ModelKnobs(remat="full")):
        loss, g = _port_grads(tp, tcfg, tb, knobs)
        assert torch.equal(loss, base_loss), knobs
        for a, b in zip(flatten(base)[1], flatten(g)[1]):
            assert torch.equal(a, b), knobs


def test_train_step_matches_jax(ref):
    """One Adam step of ``build_train_step`` at the default setting against
    JAX's: at that setting JAX's step is its optimizer's update with
    ``value_and_grad``'s gradients, so the fixture's gradients feed JAX's
    own ``opt_update``.  New parameters within one bf16 step of their size
    plus 2 * lr (Adam's first step moves a weight by about lr whatever the
    gradient's size), m and v within the gradient bound, as
    test_torch_train_step.py holds the dense step."""
    _, _, tcfg, jp, _, tb, jl, jg = ref
    opt_init, opt_update = j_make_optimizer(JTrainConfig())
    jstate = {"params": jp, "opt": opt_init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = train_state_from_numpy(_tree_np(jstate), device="cpu")
    jgrads = jax.tree_util.tree_map(jnp.asarray, jg)
    new_p, new_opt = jax.jit(opt_update)(jp, jgrads, jstate["opt"])
    tstate, m = build_train_step(tcfg, TrainConfig(), StepKnobs())(tstate, tb)
    assert abs(float(m["loss"]) - jl) <= LOSS_TOL
    lr = TrainConfig().learning_rate
    assert_leaves_close(_tree_np(new_p), tstate["params"], 2 ** -7,
                        "params", atol=2 * lr)
    for k in ("m", "v"):
        rtol = 2 * GRAD_RTOL if k == "v" else GRAD_RTOL
        assert_leaves_close(_tree_np(new_opt)[k], tstate["opt"][k], rtol,
                            f"opt/{k}")
    assert int(tstate["step"]) == 1 == int(tstate["opt"]["count"])


@pytest.mark.parametrize("arch,selftune", [("falcon-mamba-7b", False),
                                           ("zamba2-1.2b", True)])
def test_train_launcher_runs_ssm_and_hybrid_on_cpu(arch, selftune, capsys):
    """``python -m repro_torch.launch.train --arch ... --reduced --device
    cpu`` trains both families and ends in OK, fixed (falcon-mamba) and
    self-tuned (zamba2)."""
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "4",
            "--batch", "2", "--seq", "16"]
    if selftune:
        args += ["--self-tune", "--tuner-a", "2", "--tuner-b", "1"]
    launch_train.main(args)
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK") and "done: iters=4" in out
    if selftune:
        assert "final setting" in out
