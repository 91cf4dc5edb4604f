"""The port's MoCo (`faceposegenerator_tpu_torch/training/moco.py`) against
the JAX package's `training/moco.py`.

The toy encoder of tests/test_moco_heatmaps_flops.py:18-25 (a (128, 48)
dense on flattened 4×4×3 images), `MoCoConfig(dim=128, queue_size=256,
momentum=0.9)`, `optax.sgd(0.1)` on the JAX side and the port's `sgd(0.1)`
(`training/fr.py`'s SGD with no clip and no decay) on the other. JAX's
initial weights and queue are carried across as numpy, and both sides take
four steps, each on a batch of 8 of its own (JAX's test repeats one batch:
from the second step on, the queue then holds the previous keys of the same
images, which tie with the positives to within rounding, and the accuracy's
argmax is decided by the rounding):
  - one process: each step's loss, accuracy, query and key weights, queue
    and pointer within 1e-5 of JAX's;
  - two gloo ranks (this file run as a script, 4 rows a rank, one torch
    thread each, no JAX): the gradients averaged and the keys gathered over
    "data", so each step's loss (the ranks' mean) and the weights, queue
    and pointer after it within 1e-5 of JAX's one-device step on the whole
    batch, bit-equal on the two ranks; `shuffle_bn` across the ranks (the
    global batch permuted, each rank's rows taken back) undone by its
    indices; a `torch.optim.SGD` run through the same steps.
  - `shuffle_bn` within one batch undone by its indices.
"""

import os
import sys

import numpy as np
import pytest
import torch

TIMEOUT_S = 120.0
STEPS, LR = 4, 0.1
CFG = dict(dim=128, queue_size=256, momentum=0.9)


def _port_state(inp):
    from faceposegenerator_tpu_torch.training import moco

    return moco.init_moco(torch.Generator().manual_seed(0), lambda g: {"w": torch.from_numpy(inp["w"].copy())},
                          moco.MoCoConfig(**CFG), queue=inp["queue"])


def _apply(params, x):
    return x.reshape(x.shape[0], -1) @ params["w"].T


def _run(inp, rows=slice(None), mesh=None, optimizer="sgd"):
    """STEPS port steps on `rows` of the batch: each step's (loss, acc,
    params_q, params_k, queue, queue_ptr)."""
    from faceposegenerator_tpu_torch.core.tree import tree_leaves
    from faceposegenerator_tpu_torch.training import moco

    cfg = moco.MoCoConfig(**CFG)
    state = _port_state(inp)
    if optimizer == "sgd":
        opt = moco.sgd(LR)
        opt_state = opt.init(state["params_q"])
    else:
        opt, opt_state = torch.optim.SGD(tree_leaves(state["params_q"]), lr=LR), None
    out = []
    for i in range(STEPS):
        q, k = (torch.from_numpy(inp[n][i][rows]) for n in ("q", "k"))
        loss, state, opt_state, aux = moco.moco_step(state, _apply, opt, opt_state, q, k, cfg, mesh=mesh)
        out.append({"loss": float(loss), "acc": float(aux["acc"]), "w_q": state["params_q"]["w"].numpy().copy(),
                    "w_k": state["params_k"]["w"].numpy().copy(), "queue": state["queue"].numpy().copy(),
                    "queue_ptr": int(state["queue_ptr"])})
    return out


# --------------------------------------------------------------------------
# the ranks (this file run as a script; no JAX)
# --------------------------------------------------------------------------

def _rank_main(inputs_path, out_dir, rank, world, port):
    torch.set_num_threads(1)
    from faceposegenerator_tpu_torch.core import dist
    from faceposegenerator_tpu_torch.core.mesh import all_gather_rows, make_mesh, rows_of
    from faceposegenerator_tpu_torch.training import moco

    inp = torch.load(inputs_path, weights_only=False)
    dist.init_distributed(f"127.0.0.1:{port}", world, rank, platform="cpu", timeout_s=TIMEOUT_S)
    mesh = make_mesh(data=world, device="cpu")
    rows = rows_of(mesh, inp["q"].shape[1])
    out = {"sgd": _run(inp, rows, mesh), "torch_sgd": _run(inp, rows, mesh, optimizer="torch")}
    x = torch.from_numpy(inp["q"][0][rows])
    shard, (perm, inv) = moco.shuffle_bn(x, torch.Generator().manual_seed(7), mesh)
    out["shuffle"] = {"perm": perm.numpy(), "undone": all_gather_rows(mesh, shard)[inv][rows].numpy(),
                      "x": x.numpy()}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier("saved")
    dist.shutdown()


# --------------------------------------------------------------------------
# the parent
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run():
    """JAX's init and STEPS steps on the whole batch (the JAX test's
    encoder, batch and optimizer)."""
    import jax
    import optax

    from faceposegenerator_tpu.training import moco as jmoco

    cfg = jmoco.MoCoConfig(**CFG)
    state = jmoco.init_moco(jax.random.key(0), lambda key: {"w": jax.random.normal(key, (128, 48))}, cfg)
    inp = {"w": np.asarray(state["params_q"]["w"]), "queue": np.asarray(state["queue"])}
    q = jax.random.normal(jax.random.key(1), (STEPS, 8, 4, 4, 3))
    k = q + 0.01 * jax.random.normal(jax.random.key(2), q.shape)
    inp["q"], inp["k"] = np.array(q), np.array(k)
    opt = optax.sgd(LR)
    opt_state = opt.init(state["params_q"])
    step = jax.jit(lambda s, o, q, k: jmoco.moco_step(s, _apply, opt, o, q, k, cfg))
    steps = []
    for i in range(STEPS):
        loss, state, opt_state, aux = step(state, opt_state, q[i], k[i])
        steps.append({"loss": float(loss), "acc": float(aux["acc"]), "w_q": np.asarray(state["params_q"]["w"]),
                      "w_k": np.asarray(state["params_k"]["w"]), "queue": np.asarray(state["queue"]),
                      "queue_ptr": int(state["queue_ptr"])})
    return inp, steps


@pytest.fixture(scope="module")
def ranks(jax_run, tmp_path_factory):
    from faceposegenerator_tpu_torch.core.dist import free_port, spawn

    tmp = str(tmp_path_factory.mktemp("moco"))
    path = os.path.join(tmp, "inputs.pt")
    torch.save(jax_run[0], path)
    port = free_port()
    with pytest.MonkeyPatch.context() as mp:
        for k in ("FPG_COORDINATOR", "FPG_NUM_PROCESSES", "FPG_PROCESS_ID", "RANK", "WORLD_SIZE", "MASTER_ADDR"):
            mp.delenv(k, raising=False)
        spawn([[sys.executable, os.path.abspath(__file__), path, tmp, str(r), "2", str(port)] for r in range(2)],
              lambda i: {"OMP_NUM_THREADS": "1"}, TIMEOUT_S, log_dir=tmp)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(2)]


def _check(got, want, what):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["queue_ptr"] == w["queue_ptr"] == 8 * (i + 1) % CFG["queue_size"], f"{what} step {i}"
        for key in ("loss", "acc", "w_q", "w_k", "queue"):
            np.testing.assert_allclose(g[key], w[key], atol=1e-5, rtol=1e-5, err_msg=f"{what} step {i} {key}")


def test_moco_steps_match_jax(jax_run):
    inp, want = jax_run
    _check(_run(inp), want, "one process")
    # the positive pair wins against the queue's other images
    assert all(w["acc"] == 1.0 for w in want)


def test_moco_steps_over_two_ranks_match_jax_on_the_whole_batch(ranks, jax_run):
    want = jax_run[1]
    for r in ranks:
        _check(r["sgd"], want, "two ranks")
        _check(r["torch_sgd"], want, "two ranks, torch.optim.SGD")
    for a, b in zip(ranks[0]["sgd"], ranks[1]["sgd"]):
        for key in ("w_q", "w_k", "queue"):
            np.testing.assert_array_equal(a[key], b[key])


def test_shuffle_bn_round_trip_across_ranks(ranks):
    perms = [r["shuffle"]["perm"] for r in ranks]
    np.testing.assert_array_equal(perms[0], perms[1])
    assert sorted(perms[0].tolist()) == list(range(8))
    for r in ranks:
        np.testing.assert_array_equal(r["shuffle"]["undone"], r["shuffle"]["x"])


def test_shuffle_bn_round_trip():
    from faceposegenerator_tpu_torch.training import moco

    x = torch.arange(12.0).reshape(6, 2)
    shuffled, (perm, inv) = moco.shuffle_bn(x, torch.Generator().manual_seed(0))
    assert not torch.equal(shuffled, x)
    torch.testing.assert_close(shuffled[inv], x, rtol=0, atol=0)
    torch.testing.assert_close(x[perm], shuffled, rtol=0, atol=0)


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5]))
