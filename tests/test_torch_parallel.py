"""Data parallelism over batch x EOT in the port (parallel/mesh.py,
serving.py) against diffpure_tpu's on the CPU: ``shard_defended_call``
over 2 and 4 shards against JAX's on its virtual 8-device mesh, each
shard's draw JAX's own (injected by the shard's seed); the shard order of
``P(("data", "eot"))``; distinct noise per shard; ``eot_fold`` /
``eot_unfold``; ``make_mesh``'s shapes and its raise where JAX would fall
back to virtual CPU devices; the ``DefendedModel`` served over a mesh
(the CLI's path) against its per-shard calls, bit for bit, and against
the unsharded call for every runner's noise on uneven shards; and
robustness_eval through it on batches that do not divide."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.parallel import eot_fold as jeot_fold
from diffpure_tpu.parallel import eot_unfold as jeot_unfold
from diffpure_tpu.parallel import make_mesh as jmake_mesh
from diffpure_tpu.parallel.serving import shard_defended_call as jshard
from diffpure_tpu_torch.eval import DefendedModel
from diffpure_tpu_torch.models import NCSNpp
from diffpure_tpu_torch.parallel import ShardedDefendedModel, eot_fold, eot_unfold, \
    initialize_distributed, make_mesh, replicate, shard_batch, shard_defended_call
from diffpure_tpu_torch.purify import BatchSlice, PurifyConfig
from diffpure_tpu_torch.utils.prng import fold_in
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from torch_parity import assert_close

CPU = torch.device("cpu")
SIGMA = 0.1


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((48, 16)) / np.sqrt(48)).astype(np.float32),
            rng.standard_normal((16, 10)).astype(np.float32))


def _jax_call(W1, W2):
    def call(score_params, clf_params, x01, k):
        x = x01 + SIGMA * jax.random.normal(k, x01.shape)  # the "purifier"'s draw
        return jnp.tanh(x.reshape(x.shape[0], -1) @ score_params) @ clf_params
    return call


@pytest.mark.parametrize("data,eot", [(2, 1), (2, 2)])
def test_shard_defended_call_matches_jax(data, eot):
    W1, W2 = _weights()
    x = np.random.default_rng(1).uniform(size=(8, 4, 4, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jmesh = jmake_mesh(data=data, eot=eot, devices=jax.devices()[:data * eot])
    want = jshard(_jax_call(W1, W2), jmesh)(
        jnp.asarray(W1), jnp.asarray(W2), jnp.asarray(x), key)
    # shard i draws JAX's fold_in(key, i): injected by the seed the port hands it
    seed, per = 11, 8 // (data * eot)
    draws = {fold_in(seed, i): torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key, i), (per, 4, 4, 3)))) for i in range(data * eot)}
    score, clf = torch.nn.Linear(48, 16, bias=False), torch.nn.Linear(16, 10, bias=False)
    with torch.no_grad():
        score.weight.copy_(torch.from_numpy(W1.T))
        clf.weight.copy_(torch.from_numpy(W2.T))

    def call(s_mod, c_mod, x01, s):
        xn = x01 + SIGMA * draws[s]
        return c_mod(torch.tanh(s_mod(xn.reshape(xn.shape[0], -1))))

    mesh = make_mesh(data=data, eot=eot, devices=[CPU] * (data * eot))
    with torch.no_grad():
        got = shard_defended_call(call, mesh, score, clf)(torch.from_numpy(x), seed)
    assert got.shape == (8, 10)
    assert_close(got, want, 1e-5, f"{data} x {eot} shards")


def test_shards_draw_distinct_noise():
    mesh = make_mesh(data=4, devices=[CPU] * 4)

    def call(x01, s):
        g = torch.Generator().manual_seed(s)
        return x01 + torch.randn(x01.shape, generator=g)

    x = torch.zeros(2, 3).repeat(4, 1)  # the same two examples on every shard
    out = shard_defended_call(call, mesh)(x, 0).reshape(4, 2, 3)
    assert min(float((out[i] - out[0]).abs().max()) for i in range(1, 4)) > 1e-3


def test_shard_order_and_placement():
    """Shard i of the batch goes to the mesh's i-th device, in JAX's
    ("data", "eot") order: data index major."""
    mesh = make_mesh(data=2, eot=2, devices=[CPU] * 4)
    x = torch.arange(8.0)[:, None]
    shards = shard_batch(x, mesh)
    assert [s[:, 0].tolist() for s in shards] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError):
        shard_batch(torch.zeros(6, 1), mesh)
    m = torch.nn.Linear(2, 2)
    assert replicate(m, mesh) == {CPU: m}


def test_eot_fold_unfold_match_jax():
    x = np.arange(6.0, dtype=np.float32).reshape(2, 3)
    f = eot_fold(torch.from_numpy(x), 4)
    assert np.array_equal(f.numpy(), np.asarray(jeot_fold(jnp.asarray(x), 4)))
    u = eot_unfold(f, 4)
    assert u.shape == (4, 2, 3) and torch.equal(u[3], torch.from_numpy(x))
    assert np.array_equal(u.numpy(), np.asarray(jeot_unfold(jeot_fold(jnp.asarray(x), 4), 4)))


def test_make_mesh_shapes_and_the_cuda_raise():
    """Shapes as JAX's; where JAX falls back to virtual CPU devices, asking
    for more CUDA devices than there are raises."""
    cpus = [CPU] * 8
    assert make_mesh(devices=cpus).shape == {"data": 8, "eot": 1}
    assert make_mesh(data=4, eot=2, devices=cpus).shape == {"data": 4, "eot": 2}
    assert make_mesh(eot=4, devices=cpus).shape == {"data": 2, "eot": 4}
    with pytest.raises(ValueError):
        make_mesh(data=3, devices=cpus)
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="CUDA"):
        make_mesh(data=n + 1)
    initialize_distributed()  # one process: a no-op
    initialize_distributed(num_processes=1)


def _tiny_ncsnpp_defence(**cfg):
    from diffpure_tpu_torch.classifiers.wideresnet import WideResNet

    score = NCSNpp(image_size=8, nf=16, ch_mult=(1, 2), num_res_blocks=1,
                   attn_resolutions=(4,)).eval()
    score.load_state_dict({k: torch.from_numpy(v) for k, v in
                           seeded_normal_state_dict(score, 0).items()})
    clf = WideResNet(depth=10, widen_factor=1).eval()
    clf.load_state_dict({k: torch.from_numpy(v) for k, v in
                         seeded_normal_state_dict(clf, 1).items()})
    return DefendedModel(score, clf, PurifyConfig(t=2, grad_mode="none", **cfg), log_every=0)


def test_sharded_defended_model_is_its_per_shard_calls():
    """The DefendedModel served over two shards: its purify, classify and
    defended call are the per-shard calls, each with its rows of the whole
    batch's noise (BatchSlice(seed, a, b, B)), concatenated, bit for bit;
    and the unsharded call to rounding, on an even and an uneven batch."""
    dm = _tiny_ncsnpp_defence()
    mesh = make_mesh(data=2, devices=[CPU, CPU])
    sharded = ShardedDefendedModel(dm, mesh)
    for B in (4, 3):
        x = torch.from_numpy(np.random.default_rng(2).uniform(size=(B, 8, 8, 3))
                             .astype(np.float32))
        rows = [(0, (B + 1) // 2), ((B + 1) // 2, B)]
        with torch.no_grad():
            for mode in ("purify", "__call__"):
                got = getattr(sharded, mode)(x, 5)
                want = torch.cat([getattr(dm, mode)(x[a:b], BatchSlice(5, a, b, B))
                                  for a, b in rows])
                assert torch.equal(got, want), (B, mode)
                assert_close(got, getattr(dm, mode)(x, 5), 1e-5, f"{mode}, batch {B}")
            assert torch.equal(sharded.classify(x),
                               torch.cat([dm.classify(x[a:b]) for a, b in rows]))


def _linear_eps(out_channels=3):
    W = torch.from_numpy(np.random.RandomState(0).randn(48, 48).astype(np.float32) * 0.01)

    def model(x, t):
        e = (x.reshape(x.shape[0], -1) @ W).reshape(x.shape)
        return torch.cat([e, torch.zeros_like(e)], -1) if out_channels == 6 else e
    return model


@pytest.mark.parametrize("runner", ["sde", "sde fix_rand", "ode", "ldsde", "dpm", "ddpm",
                                    "celebahq-ddpm"])
@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_noise_does_not_depend_on_the_mesh(runner, shards):
    """Each runner's draws through BatchSlice: a batch of 5 purified over 2
    or 3 shards (uneven; with rand_t, and two sample_step rounds for the
    SDE) is the unsharded purification, as JAX's CLI, whose one draw
    covers the whole sharded batch."""
    kind, *opt = runner.split()
    cfg = dict(diffusion_type=kind, t=3, grad_mode="none")
    if kind == "sde":
        cfg.update(rand_t=True, t_delta=1, sample_step=2, fix_rand=bool(opt))
    model = _linear_eps(6 if kind == "ddpm" else 3)
    dm = DefendedModel(model, lambda x: x.reshape(x.shape[0], -1)[:, :10],
                       PurifyConfig(**cfg), log_every=0)
    x = torch.from_numpy(np.random.default_rng(3).uniform(size=(5, 4, 4, 3)).astype(np.float32))
    sharded = ShardedDefendedModel(dm, make_mesh(data=shards, devices=[CPU] * shards))
    with torch.no_grad():
        got, want = sharded.purify(x, 9), dm.purify(x, 9)
    assert got.shape == want.shape == ((10 if kind == "sde" else 5), 4, 4, 3)
    assert_close(got, want, 1e-6, runner)


@pytest.mark.parametrize("n", [1, 3])
def test_sharded_robustness_eval_takes_any_batch(n):
    """The CLI's multi-device path: robustness_eval through a
    ShardedDefendedModel on a 2-device mesh, on 1 and 3 examples (AutoAttack
    attacks the robust ones in power-of-two buckets down to 1), gives the
    unsharded evaluation's results."""
    from diffpure_tpu_torch.eval import robustness_eval

    C = torch.from_numpy(np.random.RandomState(1).randn(48, 10).astype(np.float32))
    dm = DefendedModel(_linear_eps(), lambda x: x.reshape(x.shape[0], -1) @ C,
                       PurifyConfig(t=2), log_every=0)
    x = torch.from_numpy(np.random.default_rng(4).uniform(size=(n, 4, 4, 3)).astype(np.float32))
    y = (x.reshape(n, -1) @ C).argmax(-1)
    kw = dict(log=lambda s: None, attacks_to_run=("apgd-ce",), n_iter=4, eps=0.1)
    want = robustness_eval(dm, x, y, 0, "custom", **kw)
    got = robustness_eval(ShardedDefendedModel(dm, make_mesh(data=2, devices=[CPU, CPU])),
                          x, y, 0, "custom", **kw)
    assert got["defended_robust_acc"] == want["defended_robust_acc"]
    assert got["classifier_robust_acc"] == want["classifier_robust_acc"]
    assert_close(got["x_adv"], want["x_adv"], 1e-5, "x_adv")
