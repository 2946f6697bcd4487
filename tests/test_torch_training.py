"""The port's training surface against diffpure_tpu's, on the CPU.

- the sub-VP and VE SDEs and ``get_score_fn``'s discrete / sub-VP / VE
  branches;
- the three score-matching losses with JAX's draws injected (1e-5);
- ``get_step_fn`` on a small NCSN++: the loss and every gradient against
  ``jax.value_and_grad`` (1e-4 x max|JAX| per tensor), the step's update
  and EMA plumbing, the kernels' weight packs seeing every update;
- the optimizer alone, fed JAX's gradient trees, against optax's chain
  (warmup, clipped and unclipped steps, AdamW; 1e-6);
- EMA, the schedule samplers, the loss scaler, the kv logger;
- ``TrainLoop``: one step against JAX's with its draws injected, the loss
  descending, save / resume bit for bit, several EMA rates.
NCSN++'s training mode and init: tests/test_torch_ncsnpp_train.py.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffpure_tpu.diffusion import score as jscore
from diffpure_tpu.diffusion import sde as jsde
from diffpure_tpu.diffusion.discrete import GaussianDiffusion as JaxDiffusion
from diffpure_tpu.diffusion.schedules import linear_beta_schedule
from diffpure_tpu.models.convert import translate_ncsnpp
from diffpure_tpu.models.ema import ExponentialMovingAverage as JaxEMA
from diffpure_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from diffpure_tpu.training import losses as jlosses
from diffpure_tpu.training import precision as jprec
from diffpure_tpu.training import resample as jres
from diffpure_tpu.utils import kvlogger as jkv
from diffpure_tpu_torch.diffusion import VESDE, VPSDE, SubVPSDE, get_score_fn
from diffpure_tpu_torch.diffusion.discrete import GaussianDiffusion
from diffpure_tpu_torch.models import NCSNpp
from diffpure_tpu_torch.models.convert import ncsnpp_state_dict_from_flax
from diffpure_tpu_torch.models.ema import ExponentialMovingAverage
from diffpure_tpu_torch.models.layers import ResnetBlockBigGANpp
from diffpure_tpu_torch.training import losses, precision, resample
from diffpure_tpu_torch.training.train_loop import TrainLoop
from diffpure_tpu_torch.utils import kvlogger
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from torch_parity import assert_close, two_torch_threads  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("two_torch_threads")

# losses and closed forms: both packages compute the same float32 formulas
LOSS_REL = 1e-5
# NCSN++ gradients: fp32 on both sides, summation orders differ
GRAD_REL = 1e-4
# the optimizer alone: the same float32 arithmetic, one rounding apart
OPT_REL = 1e-6

SMALL = dict(image_size=8, nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(4,),
             dropout=0.0)


def t_(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


# ---- SDEs and score adapters -------------------------------------------------

@pytest.mark.parametrize("name", ["subvp", "ve", "vp"])
def test_sde_closed_forms_match_jax(name):
    port, ref = {"subvp": (SubVPSDE(), jsde.SubVPSDE()), "ve": (VESDE(), jsde.VESDE()),
                 "vp": (VPSDE(), jsde.VPSDE())}[name]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4, 4, 3)).astype(np.float32)
    t = np.array([0.05, 0.4, 0.97], np.float32)
    for got, want in ((port.marginal_prob(t_(x), t_(t)), ref.marginal_prob(x, t)),
                      (port.sde(t_(x), t_(t)), ref.sde(x, t))):
        for g, w in zip(got, want):
            assert_close(g, np.broadcast_to(np.asarray(w), tuple(g.shape)), LOSS_REL, name)
    assert port.T == ref.T == 1.0
    if name == "ve":
        np.testing.assert_array_equal(port.discrete_sigmas, ref.discrete_sigmas)
    if name != "vp":
        prior = port.prior_sampling((4096,), torch.Generator().manual_seed(0))
        scale = port.sigma_max if name == "ve" else 1.0
        assert abs(float(prior.std()) / scale - 1) < 0.05


def _model(lib):
    """A model of (x, labels) that depends on both, in either library."""
    if lib == "jax":
        return lambda x, t: x * 0.3 + jnp.cos(jnp.asarray(t, jnp.float32) * 0.01)[:, None, None, None]
    return lambda x, t: x * 0.3 + torch.cos(t.float() * 0.01)[:, None, None, None]


@pytest.mark.parametrize("name,continuous", [("vp", False), ("subvp", True), ("subvp", False),
                                             ("ve", True), ("ve", False), ("vp", True)])
def test_get_score_fn_branches_match_jax(name, continuous):
    port, ref = {"subvp": (SubVPSDE(), jsde.SubVPSDE()), "ve": (VESDE(), jsde.VESDE()),
                 "vp": (VPSDE(), jsde.VPSDE())}[name]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 4, 4, 3)).astype(np.float32)
    t = np.array([0.03, 0.3, 0.61, 0.99], np.float32)
    want = jscore.get_score_fn(ref, _model("jax"), continuous)(jnp.asarray(x), jnp.asarray(t))
    got = get_score_fn(port, _model("torch"), continuous)(t_(x), t_(t))
    assert_close(got, want, LOSS_REL, f"{name} continuous={continuous}")


# ---- the losses ----------------------------------------------------------------

def _jax_draws(kind, key, batch, n):
    k1, k2 = jax.random.split(key)
    if kind == "sde":
        t = jax.random.uniform(k1, (batch.shape[0],), minval=1e-5, maxval=1.0)
        return dict(t=t_(t), z=t_(jax.random.normal(k2, batch.shape, batch.dtype)))
    labels = jax.random.randint(k1, (batch.shape[0],), 0, n)
    return dict(labels=t_(labels, torch.int64), z=t_(jax.random.normal(k2, batch.shape)))


@pytest.mark.parametrize("kind,reduce_mean,weighting", [
    ("sde", True, False), ("sde", False, True), ("smld", False, False), ("ddpm", True, False)])
def test_losses_match_jax_with_injected_draws(kind, reduce_mean, weighting):
    rng = np.random.default_rng(2)
    batch = rng.uniform(-1, 1, (3, 4, 4, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    if kind == "sde":
        ref = jlosses.get_sde_loss_fn(jsde.VPSDE(), True, reduce_mean, True, weighting)
        port = losses.get_sde_loss_fn(VPSDE(), True, reduce_mean, True, weighting)
        n = None
    elif kind == "smld":
        ref, port = jlosses.get_smld_loss_fn(jsde.VESDE(), True), losses.get_smld_loss_fn(VESDE(), True)
        n = 1000
    else:
        ref, port = jlosses.get_ddpm_loss_fn(jsde.VPSDE(), True), losses.get_ddpm_loss_fn(VPSDE(), True)
        n = 1000
    want = ref(key, _model("jax"), jnp.asarray(batch))
    got = port(None, _model("torch"), t_(batch), _jax_draws(kind, key, batch, n))
    assert_close(got, want, LOSS_REL, kind)
    # drawn by the port itself: finite, and the same for the same generator
    a = port(torch.Generator().manual_seed(3), _model("torch"), t_(batch))
    b = port(torch.Generator().manual_seed(3), _model("torch"), t_(batch))
    assert torch.isfinite(a) and float(a) == float(b)


# ---- get_step_fn on a small NCSN++ -----------------------------------------------

@pytest.fixture(scope="module")
def small_ncsnpp():
    model = NCSNpp(**SMALL)
    sd = seeded_normal_state_dict(model, 0)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model, translate_ncsnpp(sd)


def _grads_by_name(tree):
    return {k: v for k, v in ncsnpp_state_dict_from_flax(tree).items() if k != "sigmas"}


def test_step_fn_loss_and_gradients_match_jax(small_ncsnpp):
    model, jparams = small_ncsnpp
    rng = np.random.default_rng(4)
    batch = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jnet = JaxNCSNpp(**SMALL)
    jloss = jlosses.get_sde_loss_fn(jsde.VPSDE(), True)
    want_loss, want_grads = jax.jit(jax.value_and_grad(lambda p: jloss(
        key, lambda x, t: jnet.apply(p, x, t), jnp.asarray(batch))))(jparams)

    opt = losses.get_optimizer(lr=1e-3, warmup=0)
    params = list(model.parameters())
    snapshot = [p.detach().clone() for p in params]
    state = dict(params=model, opt_state=opt.init(params), step=0,
                 ema=ExponentialMovingAverage(params, 0.9, use_num_updates=False))
    step_fn = losses.get_step_fn(VPSDE(), train=True, optimizer=opt)
    draws = _jax_draws("sde", key, batch, None)
    loss_fn = losses.get_sde_loss_fn(VPSDE(), True)
    got_grads = torch.autograd.grad(loss_fn(None, model, t_(batch), draws), params)
    new_state, got_loss = step_fn(state, t_(batch), draws=draws)

    assert_close(got_loss, want_loss, GRAD_REL, "loss")
    names = [n for n, _ in model.named_parameters()]
    want = _grads_by_name(want_grads)
    assert set(names) == set(want)
    top = max(float(w.abs().max()) for w in want.values())
    for name, g in zip(names, got_grads):
        if float(want[name].abs().max()) < 1e-6 * top:
            # zero but for rounding: the key bias, which the softmax cancels
            assert float(g.abs().max()) < 1e-6 * top, name
            continue
        assert_close(g, want[name], GRAD_REL, name)

    # the step's plumbing: the optimizer on these gradients, then the EMA
    ref_state = opt.init(snapshot)
    updates, _ = opt.update(got_grads, ref_state, snapshot)
    for p, p0, u in zip(params, snapshot, updates):
        assert_close(p, p0 + u, OPT_REL)
    for s, p0, p in zip(new_state["ema"].shadow_params, snapshot, params):
        assert_close(s, p0 - 0.1 * (p0 - p), OPT_REL)
    assert new_state["step"] == 1 and new_state["opt_state"]["count"] == 1
    with torch.no_grad():
        for p, p0 in zip(params, snapshot):
            p.copy_(p0)

    # the eval step returns the loss and leaves the weights alone
    _, eval_loss = losses.get_step_fn(VPSDE(), train=False)(state, t_(batch), draws=draws)
    assert_close(eval_loss, want_loss, GRAD_REL, "eval loss")


def test_step_fn_discrete_and_refusals(small_ncsnpp):
    model, _ = small_ncsnpp
    with pytest.raises(NotImplementedError, match="item 20"):
        losses.get_step_fn(VPSDE(), train=True, data_axis="data")
    with pytest.raises(ValueError):
        losses.get_step_fn(SubVPSDE(), train=True, continuous=False)
    step = losses.get_step_fn(VPSDE(), train=False, continuous=False)
    _, loss = step(dict(params=model, step=0), torch.zeros(2, 8, 8, 3),
                   torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)


def test_weight_updates_reach_the_blocks_kernel_packs():
    """An optimizer step (foreach add) and an EMA copy_to / restore bump the
    version counters the blocks' kernel packs are keyed by; a write
    through ``p.data`` would not."""
    blk = ResnetBlockBigGANpp(16, 16, temb_dim=8)
    p = blk.Conv_0.weight
    stamps = [p._version]
    losses.apply_updates([p], [torch.ones_like(p)])
    stamps.append(p._version)
    ema = ExponentialMovingAverage(blk, 0.5)
    ema.store(blk)
    ema.copy_to(blk)
    stamps.append(p._version)
    ema.restore(blk)
    stamps.append(p._version)
    assert stamps == sorted(set(stamps)), stamps
    v = p._version
    p.data.copy_(p.detach() + 1)
    assert p._version == v  # why the port never writes through .data


# ---- the optimizer alone ----------------------------------------------------------

def _tree(rng, scale):
    return {"a": (rng.standard_normal((3, 5)) * scale).astype(np.float32),
            "b": (rng.standard_normal((7,)) * scale).astype(np.float32)}


@pytest.mark.parametrize("weight_decay,warmup", [(0.0, 3), (0.05, 0), (0.05, 2)])
def test_optimizer_matches_optax(weight_decay, warmup):
    rng = np.random.default_rng(5)
    params = _tree(rng, 1.0)
    # global norms: far above the clip, below it, above, below, above
    grads = [_tree(rng, s) for s in (3.0, 0.05, 1.0, 0.02, 0.7, 0.1)]
    ref = jlosses.get_optimizer(lr=0.1, weight_decay=weight_decay, warmup=warmup)
    port = losses.get_optimizer(lr=0.1, weight_decay=weight_decay, warmup=warmup)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = ref.init(jp)
    tp = [t_(params["a"]), t_(params["b"])]
    state = port.init(tp)
    norms = []
    for i, g in enumerate(grads):
        norms.append(float(optax.global_norm(g)))
        upd, jstate = ref.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        before = [p.clone() for p in tp]
        u, state = port.update([t_(g["a"]), t_(g["b"])], state, tp)
        losses.apply_updates(tp, u)
        if i == 0 and warmup:
            assert all(torch.equal(a, b) for a, b in zip(before, tp))  # lr(0) = 0
        for got, key in zip(tp, ("a", "b")):
            assert_close(got, jp[key], OPT_REL, f"update {i} {key}")
    adam_state = jstate[-1][0]
    for got, key in zip(state["mu"], ("a", "b")):
        assert_close(got, adam_state.mu[key], OPT_REL, "mu")
    assert state["count"] == len(grads) == int(adam_state.count)
    assert max(norms) > 1.0 > min(norms)  # clipped and unclipped steps


def test_optimization_manager_matches_optax():
    rng = np.random.default_rng(6)
    ref, port = jlosses.optimization_manager(warmup=3), losses.optimization_manager(warmup=3)
    jstate, state = ref.init(None), port.init()
    for s in (2.0, 0.1, 5.0, 0.3, 0.2):
        g = _tree(rng, s)
        want, jstate = ref.update(g, jstate)
        got, state = port.update([t_(g["a"]), t_(g["b"])], state)
        for a, key in zip(got, ("a", "b")):
            assert_close(a, want[key], OPT_REL, key)


def test_clip_by_global_norm_is_optax_not_torch():
    g = [torch.full((4,), 1.0)]  # norm 2
    clipped = losses.clip_by_global_norm(g, 1.0)
    assert torch.equal(clipped[0], g[0] / 2.0 * 1.0)
    assert torch.equal(losses.clip_by_global_norm(g, 2.5)[0], g[0])


# ---- EMA, samplers, scaler, logger ------------------------------------------------

@pytest.mark.parametrize("use_num_updates", [True, False])
def test_ema_matches_jax(use_num_updates):
    rng = np.random.default_rng(7)
    p0 = _tree(rng, 1.0)
    jema = JaxEMA.create(jax.tree_util.tree_map(jnp.asarray, p0), 0.95, use_num_updates)
    params = [t_(p0["a"]), t_(p0["b"])]
    ema = ExponentialMovingAverage(params, 0.95, use_num_updates)
    for _ in range(12):
        new = _tree(rng, 1.0)
        jema = jema.update(jax.tree_util.tree_map(jnp.asarray, new))
        ema.update([t_(new["a"]), t_(new["b"])])
    for got, key in zip(ema.shadow_params, ("a", "b")):
        assert_close(got, jema.shadow_params[key], OPT_REL, key)
    assert ema.state_dict()["num_updates"] == (12 if use_num_updates else None)
    module = torch.nn.Linear(5, 3)
    e2 = ExponentialMovingAverage(module, 0.9)
    e2.load_state_dict(ExponentialMovingAverage(module, 0.9).state_dict())


def test_schedule_samplers_match_jax():
    key = jax.random.PRNGKey(8)
    t_j, w_j = jres.UniformSampler(50).sample(key, 16)
    t_p, w_p = resample.UniformSampler(50).sample(None, 16, t=t_(t_j, torch.int64))
    assert torch.equal(t_p, t_(t_j, torch.int64)) and torch.equal(w_p, t_(w_j))
    drawn, _ = resample.create_named_schedule_sampler("uniform", 50).sample(
        torch.Generator().manual_seed(0), 256)
    assert 0 <= int(drawn.min()) and int(drawn.max()) < 50

    js = jres.LossSecondMomentResampler.create(6, history_per_term=3)
    assert isinstance(resample.create_named_schedule_sampler("loss-second-moment", 6),
                      resample.LossSecondMomentResampler)
    ps = resample.LossSecondMomentResampler.create(6, history_per_term=3)
    rng = np.random.default_rng(9)
    for i in range(5):
        ts = rng.integers(0, 6, 10)
        ls = rng.uniform(0, 5, 10).astype(np.float32)
        js = js.update_with_losses(jnp.asarray(ts), jnp.asarray(ls))
        ps = ps.update_with_losses(torch.from_numpy(ts), torch.from_numpy(ls))
        assert_close(ps.loss_history, js.loss_history, 0, f"history {i}")
        np.testing.assert_array_equal(ps.loss_counts.numpy(), np.asarray(js.loss_counts))
        assert_close(ps.weights(), js.weights(), OPT_REL, f"weights {i}")
    assert ps._warmed_up()
    t_j, w_j = js.sample(jax.random.PRNGKey(10), 32)
    t_p, w_p = ps.sample(None, 32, t=t_(t_j, torch.int64))
    assert_close(w_p, w_j, OPT_REL, "importance weights")
    t_d, _ = ps.sample(torch.Generator().manual_seed(1), 64)
    assert t_d.shape == (64,)


def test_loss_scaler_matches_jax():
    js, ps = jprec.DynamicLossScaler.create(10.0), precision.DynamicLossScaler.create(10.0)
    for finite in (True, True, False, True, False, False, True):
        js, ps = js.update(jnp.asarray(finite)), ps.update(finite)
        assert abs(ps.log_scale - float(js.log_scale)) < 1e-5
        assert abs(ps.scale / float(js.scale) - 1) < 1e-5
    g = [torch.ones(3) * 8.0, torch.tensor([float("inf")])]
    assert not precision.grads_finite(g) and precision.grads_finite(g[:1])
    assert not bool(jprec.grads_finite([jnp.ones(3), jnp.asarray([jnp.inf])]))
    assert_close(ps.unscale_grads(g[:1])[0], js.unscale_grads([jnp.ones(3) * 8.0])[0], OPT_REL)
    assert float(ps.scale_loss(torch.tensor(2.0))) == pytest.approx(float(js.scale_loss(2.0)),
                                                                     rel=1e-5)
    pol = precision.bf16_policy()
    assert pol.cast_to_compute([torch.ones(2)])[0].dtype == torch.bfloat16
    assert precision.fp32_policy().cast_output(torch.ones(1, dtype=torch.bfloat16)).dtype \
        == torch.float32


def test_kvlogger_writes_what_jax_writes(tmp_path):
    outs = {}
    for name, mod in (("jax", jkv), ("port", kvlogger)):
        d = str(tmp_path / name)
        lg = mod.KVLogger(output_formats=[mod.make_output_format(f, d)
                                          for f in ("json", "csv", "log")])
        lg.logkv("x", 1.5)
        lg.logkv_mean("m", 1.0)
        lg.logkv_mean("m", 2.0)
        lg.dumpkvs()
        lg.logkv("x", 2.5)
        lg.logkv("y", torch.tensor(3.0) if name == "port" else jnp.asarray(3.0))
        with lg.profile_kv("work"):
            pass
        lg.name2val["wait_work"] = 0.0  # a timing: not comparable
        lg.dumpkvs()
        outs[name] = [open(os.path.join(d, f)).read()
                      for f in ("progress.json", "progress.csv", "log.txt")]
    assert outs["port"] == outs["jax"]
    assert json.loads(outs["port"][0].splitlines()[0]) == {"x": 1.5, "m": 1.5}
    kvlogger.logkv("a", 1)
    assert kvlogger.dumpkvs()["a"] == 1


# ---- TrainLoop ---------------------------------------------------------------------

class TinyEps(torch.nn.Module):
    """conv -> swish -> conv, as tests/test_training_aux.py's flax Tiny."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.Conv_1 = torch.nn.Conv2d(8, 3, 3, padding=1)

    def forward(self, x, t):
        h = torch.nn.functional.silu(self.Conv_0(x.permute(0, 3, 1, 2)))
        return self.Conv_1(h).permute(0, 2, 3, 1)


class _Injected:
    """JAX TrainLoop's draws for its step i, handed to the port's: t through
    the sampler, the noise through training_losses."""

    def __init__(self, diffusion, ts, noises):
        self.diffusion, self.ts, self.noises = diffusion, list(ts), list(noises)
        self.num_timesteps = diffusion.num_timesteps

    def sample(self, generator, n, device=None):
        return resample.UniformSampler(self.num_timesteps).sample(None, n, t=self.ts.pop(0))

    def training_losses(self, model_fn, x, t, generator=None):
        return self.diffusion.training_losses(model_fn, x, t, noise=self.noises.pop(0))


def _jax_tiny_params(model):
    sd = model.state_dict()
    return {"params": {f"Conv_{i}": {"kernel": sd[f"Conv_{i}.weight"].permute(2, 3, 1, 0).numpy(),
                                     "bias": sd[f"Conv_{i}.bias"].numpy()} for i in (0, 1)}}


def test_train_loop_step_matches_jax(tmp_path):
    import flax.linen as nn
    from diffpure_tpu.training.train_loop import TrainLoop as JaxTrainLoop

    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, x, t):
            h = nn.swish(nn.Conv(8, (3, 3), padding="SAME")(x))
            return nn.Conv(3, (3, 3), padding="SAME")(h)

    torch.manual_seed(0)
    model = TinyEps()
    jparams = jax.tree_util.tree_map(jnp.asarray, _jax_tiny_params(model))
    betas = linear_beta_schedule(20, 1e-4, 2e-2)
    rng = np.random.default_rng(11)
    batches = [rng.standard_normal((4, 8, 8, 3)).astype(np.float32) * 0.1 for _ in range(3)]
    jloop = JaxTrainLoop(apply_fn=lambda p, x, t: Tiny().apply(p, x, t),
                         diffusion=JaxDiffusion.from_betas(betas), data=iter(()),
                         params=jparams, batch_size=4, lr=1e-2, ema_rate=(0.9, 0.5),
                         lr_anneal_steps=10, weight_decay=0.01,
                         checkpoint_dir=str(tmp_path / "j"), seed=3)
    # JAX's draws for each step: the loop's key split, then training_losses'
    key, ts, noises = jax.random.PRNGKey(3), [], []
    for b in batches:
        key, k_t, k_loss = jax.random.split(key, 3)
        ts.append(t_(jloop.schedule_sampler.sample(k_t, 4)[0], torch.int64))
        noises.append(t_(jax.random.normal(jax.random.split(k_loss)[1], b.shape)))
    inj = _Injected(GaussianDiffusion(betas), ts, noises)
    loop = TrainLoop(model=model, diffusion=inj, data=iter(()), batch_size=4, lr=1e-2,
                     ema_rate=(0.9, 0.5), lr_anneal_steps=10, weight_decay=0.01,
                     schedule_sampler=inj, checkpoint_dir=str(tmp_path / "p"))
    for b in batches:
        want = jloop.run_step(jnp.asarray(b))
        got = loop.run_step(t_(b))
        assert got == pytest.approx(want, rel=1e-5)
    got_sd = _jax_tiny_params(model)["params"]
    for name in ("Conv_0", "Conv_1"):
        for leaf in ("kernel", "bias"):
            assert_close(got_sd[name][leaf], jloop.params["params"][name][leaf], 1e-5,
                         f"{name}/{leaf}")
    for e, je in zip(loop.emas, jloop.emas):
        for (n, p), s in zip(model.named_parameters(), e.shadow_params):
            mod, leaf = n.split(".")
            w = np.asarray(je.shadow_params["params"][mod]["kernel" if leaf == "weight" else "bias"])
            assert_close(s.permute(2, 3, 1, 0) if s.ndim == 4 else s, w, 1e-5, n)


def test_train_loop_descends_and_resumes_bit_for_bit(tmp_path):
    diffusion = GaussianDiffusion(linear_beta_schedule(20, 1e-4, 2e-2))
    rng = np.random.default_rng(0)

    def data_gen():
        while True:
            yield rng.standard_normal((8, 8, 8, 3)).astype(np.float32) * 0.1, {}

    torch.manual_seed(0)
    loop = TrainLoop(model=TinyEps(), diffusion=diffusion, data=data_gen(), batch_size=8,
                     lr=1e-2, ema_rate=(0.9999, 0.99), log_interval=100, save_interval=100,
                     checkpoint_dir=str(tmp_path / "ckpt"))
    batches = [t_(next(data_gen())[0]) for _ in range(14)]
    step_losses = [loop.run_step(b) for b in batches[:12]]
    assert np.mean(step_losses[-4:]) < np.mean(step_losses[:4])
    path = loop.save()
    assert os.path.basename(path) == "step_00000012.pt"
    assert [e.decay for e in loop.emas] == [0.9999, 0.99]
    assert not torch.equal(loop.emas[0].shadow_params[0], loop.emas[1].shadow_params[0])

    torch.manual_seed(1)  # another init: the checkpoint must replace it all
    loop2 = TrainLoop(model=TinyEps(), diffusion=diffusion, data=data_gen(), batch_size=8,
                      lr=1e-2, ema_rate=(0.9999, 0.99), resume_checkpoint=path,
                      checkpoint_dir=str(tmp_path / "ckpt2"))
    assert loop2.step == loop.step == 12
    for b in batches[12:]:
        assert loop.run_step(b) == loop2.run_step(b)
    for a, b in zip(loop.model.parameters(), loop2.model.parameters()):
        assert torch.equal(a, b)
    for ea, eb in zip(loop.emas, loop2.emas):
        assert all(torch.equal(a, b) for a, b in zip(ea.shadow_params, eb.shadow_params))
    assert all(torch.equal(a, b) for a, b in zip(loop.opt_state["nu"], loop2.opt_state["nu"]))

    loop3 = TrainLoop(model=TinyEps(), diffusion=diffusion, data=data_gen(), batch_size=8,
                      lr=1e-2, lr_anneal_steps=3, save_interval=2,
                      checkpoint_dir=str(tmp_path / "ckpt3"),
                      schedule_sampler=resample.create_named_schedule_sampler(
                          "loss-second-moment", 20))
    loop3.run_loop()
    assert loop3.step == 3
    assert sorted(os.listdir(tmp_path / "ckpt3")) == ["step_00000002.pt", "step_00000003.pt"]
