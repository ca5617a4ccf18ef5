"""The port's asynchronous parameter server (``parallel/ps.py``,
``scripts/train_ps.py``) against the JAX package's, on the CPU:

- ``tree_to_bytes``/``tree_from_bytes`` round trips;
- 6 gradient tickets applied by the port's ``ParameterServer`` and by
  the JAX one, from the same weights (carried by ``utils/interop.py``):
  parameters within 1e-6, for ``momentum`` and for ``adamw``;
- one worker at ``max_staleness`` 0 (synchronous SGD) on ``mlp_mnist``
  at tiny dims, against the JAX classes run the same way: parameters
  within 1e-5;
- two workers converging on the JAX test's quadratic (atol 0.05);
- the ticket order, the version cache, ``strategy: ps`` refused, no CPU
  fallback, and the script's line.
"""

import functools
import io
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_distributed_nn_tpu import config as jconfig
from pytorch_distributed_nn_tpu.data import datasets as jdata
from pytorch_distributed_nn_tpu.models import get_model as jget_model
from pytorch_distributed_nn_tpu.parallel import ps as jps
from pytorch_distributed_nn_tpu.runtime import native as jnative
from pytorch_distributed_nn_tpu.train import losses as jlosses
from pytorch_distributed_nn_tpu.train import optim as joptim
from pytorch_distributed_nn_tpu_torch import config as tconfig
from pytorch_distributed_nn_tpu_torch.config import OptimConfig
from pytorch_distributed_nn_tpu_torch.models import get_model
from pytorch_distributed_nn_tpu_torch.parallel import ps
from pytorch_distributed_nn_tpu_torch.parallel.api import make_train_step
from pytorch_distributed_nn_tpu_torch.runtime import native as tnative
from pytorch_distributed_nn_tpu_torch.scripts import train_ps
from pytorch_distributed_nn_tpu_torch.train import losses as tlosses
from pytorch_distributed_nn_tpu_torch.train import optim as toptim
from pytorch_distributed_nn_tpu_torch.utils.interop import (
    vision_params_from_jax,
    vision_params_to_jax,
)

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="the JAX package's store not built")

TINY = {"model.extra": '{"features": [16, 10]}', "data.batch_size": "16"}
OPTIMS = {
    "momentum": {"optim.name": "momentum", "optim.lr": "0.05"},
    "adamw": {"optim.name": "adamw", "optim.lr": "0.003",
              "optim.weight_decay": "0.01", "optim.warmup_steps": "2",
              "optim.schedule": "cosine"},
}
TICKETS = 6


def _pair(**overrides):
    """The JAX and the port config of mlp_mnist at tiny dims, the JAX
    model's seeded parameters and the same as the port's state_dict."""
    kw = {**TINY, **overrides}
    jcfg, tcfg = jconfig.get_config("mlp_mnist", **kw), \
        tconfig.get_config("mlp_mnist", **kw)
    x0, _ = jdata.get_dataset("mnist", seed=0, batch_size=1).batch(0)
    jmodel = jget_model(jcfg.model)
    jparams = jax.device_get(jmodel.init(
        jax.random.key(3), jnp.asarray(x0), train=False)["params"])
    tparams = vision_params_from_jax(jparams)
    return jcfg, tcfg, jmodel, jparams, tparams


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_tree_bytes_roundtrip(dtype):
    g = torch.Generator().manual_seed(0)
    tree = {"b.c": torch.randn(4, generator=g).to(dtype),
            "a": (torch.randn(2, 3, generator=g) * 10).to(dtype),
            "z.kernel": torch.zeros(0, 5, dtype=dtype)}
    back = ps.tree_from_bytes(ps.tree_to_bytes(tree), tree)
    assert list(back) == list(tree)
    for k in tree:
        assert back[k].dtype == dtype and torch.equal(back[k], tree[k])
    with pytest.raises(ValueError, match="template"):
        ps.tree_from_bytes(ps.tree_to_bytes(tree),
                           {**tree, "a": torch.zeros(3, 2, dtype=dtype)})


def test_tree_bytes_cross_the_jax_format():
    """The port's archive of a state_dict holds the JAX archive's arrays
    in the JAX leaf order (flax names sort as their dotted paths)."""
    *_, jparams, tparams = _pair()
    jz = np.load(io.BytesIO(jps.tree_to_bytes(jparams)))
    tz = np.load(io.BytesIO(ps.tree_to_bytes(tparams)))
    assert jz.files == tz.files
    for f in jz.files:
        np.testing.assert_array_equal(jz[f], tz[f])


def _push_tickets(store, grads_bytes):
    for data in grads_bytes:
        ticket = store.add("ps/grads/ticket", 1)
        store.set(f"ps/grads/{ticket}", data)


@pytest.mark.parametrize("optim", OPTIMS)
def test_ticket_sequence_matches_the_jax_server(optim):
    jcfg, tcfg, _, jparams, tparams = _pair(**OPTIMS[optim])
    rng = np.random.default_rng(11)
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in tparams.items()} for _ in range(TICKETS)]
    with jnative.StoreServer() as jsrv:
        jstore = jnative.StoreClient(port=jsrv.port)
        jserver = jps.ParameterServer(
            jstore, jparams, joptim.make_optimizer(jcfg.optim,
                                                   total_steps=TICKETS))
        _push_tickets(jstore, [jps.tree_to_bytes(vision_params_to_jax(
            {k: torch.from_numpy(v) for k, v in g.items()})[0])
            for g in grads])
        want = jax.device_get(jserver.serve(TICKETS))
        jstore.close()
    with tnative.StoreServer() as srv:
        store = tnative.StoreClient(port=srv.port)
        server = ps.ParameterServer(
            store, tparams, functools.partial(
                toptim.make_optimizer, tcfg.optim, total_steps=TICKETS),
            device="cpu")
        _push_tickets(store, [ps.tree_to_bytes(
            {k: torch.from_numpy(v) for k, v in g.items()}) for g in grads])
        got = server.serve(TICKETS)
        assert server.version == server.applied == TICKETS
        assert store.check("ps/stop")
        assert not store.check("ps/grads/1")  # drained
        published = ps.tree_from_bytes(store.get(f"ps/params/v{TICKETS}"),
                                       got)
        store.close()
    for k, v in vision_params_from_jax(want).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
        assert torch.equal(published[k], got[k])
        assert not torch.equal(got[k], tparams[k])  # the updates moved it


def _mnist_batches(n):
    ds = jdata.get_dataset("mnist", seed=0, batch_size=16)
    return [ds.batch(i) for i in range(n)]


def _jax_sync_run(jcfg, jmodel, jparams, batches):
    """The JAX classes as ``run_ps_local`` runs them, one worker at
    max_staleness 0."""
    loss_fn = jlosses.get_loss_fn("mnist")

    def loss_of(params, x, y):
        return loss_fn(jmodel.apply({"params": params}, x, train=False), y)

    grad_fn = jax.jit(jax.grad(loss_of))
    tx = joptim.make_optimizer(jcfg.optim, total_steps=len(batches))
    with jnative.StoreServer() as srv:
        server = jps.ParameterServer(jnative.StoreClient(port=srv.port),
                                     jparams, tx)
        worker = jps.PSWorker(jnative.StoreClient(port=srv.port), grad_fn,
                              jparams, max_staleness=0)
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "p", server.serve(len(batches))))
        t.start()
        worker.run([tuple(map(jnp.asarray, b)) for b in batches])
        t.join()
    return jax.device_get(out["p"])


def test_synchronous_worker_matches_the_jax_classes():
    jcfg, tcfg, jmodel, jparams, tparams = _pair()
    batches = _mnist_batches(8)
    want = _jax_sync_run(jcfg, jmodel, jparams, batches)
    model = get_model(tcfg.model, device="cpu", input_shape=(28, 28))
    model.load_state_dict(tparams)
    grad_fn = ps.model_grad_fn(model, tlosses.get_loss_fn("mnist"))
    stats = []
    got, applied = ps.run_ps_local(
        {k: p.detach() for k, p in model.named_parameters()},
        functools.partial(toptim.make_optimizer, tcfg.optim,
                          total_steps=len(batches)),
        grad_fn, [[tuple(map(torch.from_numpy, b)) for b in batches]],
        max_staleness=0, device="cpu", stats=stats)
    assert applied == len(batches)
    # synchronous: every gradient at the newest parameters
    assert stats[0]["staleness"] == [1] * len(batches)
    assert stats[0]["pushes"] == stats[0]["pulls"] == len(batches)
    assert stats[1]["applied"] == len(batches)
    for k, v in vision_params_from_jax(want).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def _quadratic():
    """min ||Wx - y||^2 (the JAX test's): convex, so stale gradients still
    converge."""
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(4, 4)).astype(np.float32)

    def grad_fn(params, x, y):
        w = params["W"].detach().requires_grad_()
        loss = ((x @ w.T - y) ** 2).mean()
        return {"W": torch.autograd.grad(loss, w)[0]}

    def batches(seed, n):
        r = np.random.default_rng(seed)
        out = []
        for _ in range(n):
            x = r.normal(size=(32, 4)).astype(np.float32)
            out.append((torch.from_numpy(x), torch.from_numpy(x @ w_true.T)))
        return out

    return {"W": torch.zeros(4, 4)}, grad_fn, batches, w_true


def _sgd(lr):
    return functools.partial(toptim.make_optimizer,
                             OptimConfig(name="sgd", lr=lr))


def _stale_schedule(store, server, workers, batches):
    """Two workers and the server stepped in one thread on a fixed
    schedule, the one the JAX harness's threads fall into (its server is
    the slow side): each worker pushes while its stale-synchronous gate is
    open, the server applies one ticket when no worker can push. Every
    gradient after the first few is computed 9-10 versions behind."""
    its = [iter(b) for b in batches]
    left = [len(b) for b in batches]
    ticket = 1
    while server.applied < sum(len(b) for b in batches):
        pushed = False
        for i, w in enumerate(workers):
            target = w._last_ticket - w.max_staleness
            if left[i] and (target <= 0 or server.version >= target):
                w.step(*next(its[i]))
                left[i] -= 1
                pushed = True
        if not pushed:
            key = f"ps/grads/{ticket}"
            server.apply_one(store.get(key, timeout_ms=10_000))
            store.delete(key)
            ticket += 1
    return server.params


def test_async_ps_converges_two_workers():
    """The JAX test's quadratic, two workers of 30 batches, sgd 0.1, on the
    staleness schedule the JAX threads run (synchronous SGD on these
    batches ends 0.09 away, so the stale steps are what converge): the
    port's server and workers and the JAX ones end within 1e-5 of each
    other and within 0.05 of the true weights."""
    params, grad_fn, batches, w_true = _quadratic()
    work = [batches(1, 30), batches(2, 30)]
    with tnative.StoreServer() as srv:
        store = tnative.StoreClient(port=srv.port)
        server = ps.ParameterServer(store, params, _sgd(0.1), device="cpu")
        workers = [ps.PSWorker(tnative.StoreClient(port=srv.port), grad_fn,
                               params) for _ in work]
        got = _stale_schedule(store, server, workers, work)["W"].numpy()
        staleness = [s for w in workers for s in w.stats["staleness"]]
    jgrad = jax.jit(jax.grad(
        lambda p, x, y: jnp.mean((x @ p["W"].T - y) ** 2)))
    jparams = {"W": np.zeros((4, 4), np.float32)}
    jwork = [[tuple(t.numpy() for t in b) for b in w] for w in work]
    with jnative.StoreServer() as srv:
        store = jnative.StoreClient(port=srv.port)
        server = jps.ParameterServer(store, jparams, optax.sgd(0.1))
        workers = [jps.PSWorker(jnative.StoreClient(port=srv.port), jgrad,
                                jparams) for _ in jwork]
        want = np.asarray(_stale_schedule(store, server, workers,
                                          jwork)["W"])
    assert max(staleness) == 10 and staleness.count(10) > 20
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, w_true, atol=0.05)


def test_async_ps_two_worker_threads_learn_the_quadratic():
    """The same on threads (``run_ps_local``), whose schedule follows the
    port's speed (staleness 1-6 on this CPU): every gradient applied once,
    the SSP gate respected, and the weights within 0.1 of the true ones
    (2.1 away at the start; synchronous SGD on these batches ends 0.09
    away)."""
    params, grad_fn, batches, w_true = _quadratic()
    stats = []
    final, applied = ps.run_ps_local(
        params, _sgd(0.1), grad_fn, [batches(1, 30), batches(2, 30)],
        device="cpu", stats=stats)
    assert applied == 60
    assert sum(w["pushes"] for w in stats[:-1]) == 60
    assert max(s for w in stats[:-1] for s in w["staleness"]) <= 2 * 9
    assert np.abs(final["W"].numpy() - w_true).max() < 0.1


def test_server_applies_in_ticket_order_and_worker_caches_versions():
    params, grad_fn, batches, _ = _quadratic()
    with tnative.StoreServer() as srv:
        server = ps.ParameterServer(tnative.StoreClient(port=srv.port),
                                    params, _sgd(0.05), device="cpu")
        worker = ps.PSWorker(tnative.StoreClient(port=srv.port), grad_fn,
                             params)
        p1 = worker.pull()
        assert worker.pull() is p1  # no new version in between
        (x, y), (x2, y2) = batches(3, 2)
        assert worker.step(x, y) == 1
        assert worker.step(x2, y2) == 2
        server.serve(total_grads=2)
        assert server.version == 2  # one republish per applied gradient
        assert server.store.check("ps/stop")
        assert worker.pull() is not p1
        assert worker.stats["staleness"] == [1, 2]  # both at version 0


def test_the_server_asks_for_the_card_unless_told():
    params, grad_fn, batches, _ = _quadratic()
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ps.run_ps_local(params, _sgd(0.1), grad_fn, [batches(1, 2)])


def test_ps_strategy_is_refused_as_in_the_jax_package():
    cfg = tconfig.get_config("mlp_mnist", **{"parallel.strategy": "ps"})
    with pytest.raises(ValueError, match="scripts/train_ps.py"):
        make_train_step(cfg, tlosses.get_loss_fn("mnist"))


def test_train_ps_script_prints_its_line(capsys):
    argv = ["--device", "cpu", "--workers", "2", "--steps", "12",
            "--model.extra", '{"features": [16, 10]}']
    assert train_ps.main(argv) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.fullmatch(r"ps: applied 12 grads from 2 workers, held-out "
                     r"loss (\d+\.\d{4})", line)
    assert m, line
    cfg, dataset, model, *_, loss_of = train_ps.setup(
        "mlp_mnist", "cpu", 12, {"model.extra": '{"features": [16, 10]}'})
    x, y = train_ps.batch_on(dataset, train_ps.HELD_OUT_STEP, "cpu")
    initial = loss_of(dict(model.named_parameters()), x, y)
    assert float(m.group(1)) < initial
