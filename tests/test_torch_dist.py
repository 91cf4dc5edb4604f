"""The port's process topology (`core/dist.py`) and mesh (`core/mesh.py`)
against the JAX package's, with no process group started.

- `init_distributed`: JAX's six cases of tests/test_dist_config.py, the
  partial and contradictory launcher configurations with JAX's messages
  word for word (JAX raises them before touching a backend, so both sides
  run here). The managed-pod refusal maps to torch's launcher variables: a
  host whose environment says it is in a pod (SLURM_JOB_ID) but which no
  launcher told how to join raises, and the module stays re-initialisable.
- NCCL with more ranks than visible cards raises, naming both counts,
  before any process group starts.
- `make_mesh`: JAX's shapes, rank layout (rank-major: JAX's process-major
  `reshape(data, model)`) and errors; `host_row_slice`, `local_batch_size`
  and `form_global_batch` against JAX's row placement.
- `make_optimizer(num_replicas=)`: JAX's `scale_lr` (tests/test_host_
  sharding.py): the first AdamW update under each schedule, with and
  without `scale_lr`, at 1 and 4 replicas, within 1e-5 of optax's.
"""

import jax
import numpy as np
import pytest
import torch

from faceposegenerator_tpu.core import dist as jdist
from faceposegenerator_tpu.core import mesh as jmesh
from faceposegenerator_tpu.training import idbooth as jidbooth
from faceposegenerator_tpu_torch.core import dist, mesh
from faceposegenerator_tpu_torch.training import idbooth

LAUNCH = ("FPG_COORDINATOR", "FPG_NUM_PROCESSES", "FPG_PROCESS_ID", "RANK", "WORLD_SIZE", "MASTER_ADDR")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for v in LAUNCH + dist._POD_ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setattr(dist, "_INITIALIZED", False)


@pytest.mark.parametrize("env,match", [
    ({"FPG_COORDINATOR": "localhost:9999"}, "partial multi-process"),
    ({"FPG_NUM_PROCESSES": "4"}, "partial multi-process"),
    ({"FPG_COORDINATOR": "localhost:9999", "FPG_NUM_PROCESSES": "1"}, "contradictory"),
])
def test_launcher_configuration_errors_match_jax_word_for_word(env, match, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=match) as got:
        dist.maybe_init_from_env()
    with pytest.raises(ValueError) as want:
        jdist.maybe_init_from_env()
    assert str(got.value) == str(want.value)
    assert dist._INITIALIZED is False


def test_no_env_is_a_noop():
    info = dist.maybe_init_from_env()
    assert info.process_count == 1 and info.is_coordinator
    assert dist.proc_info() == dist.ProcInfo(0, 1, 1, 1) and dist.is_coordinator()
    dist.barrier("alone")  # no-ops single-process
    dist.coordination_barrier("alone")
    dist.shutdown()
    dist.shutdown()  # idempotent


def test_pod_host_without_a_launcher_raises(monkeypatch):
    monkeypatch.setenv("SLURM_JOB_ID", "12345")
    with pytest.raises(RuntimeError, match="managed pod host"):
        dist.init_distributed(platform="cpu")
    assert dist._INITIALIZED is False  # the module stays re-initialisable


def test_plain_host_is_single_process():
    assert dist.init_distributed(platform="cpu").process_count == 1
    assert dist.init_distributed(platform="cpu").process_count == 1  # idempotent


def test_more_ranks_than_cards_raises_naming_both_counts(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"2 ranks on CUDA need a card each: rank 1 wants cuda:1, but 1 card is"):
        dist.init_distributed("127.0.0.1:1", 2, 1, platform="cuda")
    with pytest.raises(ValueError, match="NCCL backend needs a card"):
        dist.init_distributed("127.0.0.1:1", 2, 1, platform="cpu", backend="nccl")
    assert dist._INITIALIZED is False


@pytest.mark.parametrize("data,model,n", [(None, 1, 8), (None, 2, 8), (4, 2, 8), (2, 1, 2), (1, 2, 2)])
def test_make_mesh_shapes_and_rank_layout_match_jax(data, model, n):
    want = jmesh.make_mesh(data=data, model=model, devices=jax.devices()[:n])
    ids = np.vectorize(lambda d: d.id)(want.devices)
    for rank in range(n):
        got = mesh.make_mesh(data=data, model=model, world_size=n, rank=rank, device="cpu")
        assert got.shape == dict(want.shape)
        (i,), (j,) = np.nonzero(ids == jax.devices()[rank].id)
        assert (got.data_index, got.model_index) == (i, j) and got.rank == rank


@pytest.mark.parametrize("data,model,n", [(None, 3, 8), (3, 2, 8)])
def test_make_mesh_errors_match_jax(data, model, n):
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(data=data, model=model, devices=jax.devices()[:n])
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(data=data, model=model, world_size=n, rank=0, device="cpu")
    assert str(got.value) == str(want.value)


def test_host_rows_and_local_batch_match_jax():
    for rows, hosts in ((8, 2), (12, 4), (6, 3)):
        for h in range(hosts):
            assert mesh.host_row_slice(rows, hosts, h) == jmesh.host_row_slice(rows, hosts, h)
    for args in ((7, 2, 0), (8, 2, 2)):
        with pytest.raises(ValueError) as want:
            jmesh.host_row_slice(*args)
        with pytest.raises(ValueError) as got:
            mesh.host_row_slice(*args)
        assert str(got.value) == str(want.value)
    jm = jmesh.make_mesh(devices=jax.devices()[:4])
    pm = mesh.make_mesh(world_size=4, rank=0, device="cpu")
    assert mesh.local_batch_size(pm, 8) == jmesh.local_batch_size(jm, 8) == 2
    with pytest.raises(ValueError) as want:
        jmesh.local_batch_size(jm, 6)
    with pytest.raises(ValueError) as got:
        mesh.local_batch_size(pm, 6)
    assert str(got.value) == str(want.value)


def test_form_global_batch_places_rows_as_jax_does():
    """8 rows over 2 hosts × 2 data ranks (× 2 model ranks): each rank's
    rows from its host's slice are its shard of JAX's data-sharded array."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    jm = jmesh.make_mesh(model=2, devices=jax.devices()[:8])
    want = jax.device_put(x, jmesh.data_sharding(jm, 2))
    shards = {s.device.id: np.asarray(s.data) for s in want.addressable_shards}
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for rank in range(8):
        pm = mesh.make_mesh(model=2, world_size=8, rank=rank, device="cpu")
        host = pm.data_index // 2  # 2 hosts, each 2 data indices
        local = x[mesh.host_row_slice(8, 2, host)]
        got = mesh.form_global_batch(pm, {"x": local}, num_hosts=2, host_id=host)["x"].numpy()
        np.testing.assert_array_equal(got, shards[ids[pm.data_index, pm.model_index]])
        np.testing.assert_array_equal(mesh.shard_batch(pm, {"x": x})["x"].numpy(), got)
    with pytest.raises(ValueError, match="host-major"):
        mesh.form_global_batch(mesh.make_mesh(world_size=4, rank=3, device="cpu"), {"x": x[:4]}, 2, 0)


@pytest.mark.parametrize("scale_lr", [False, True])
@pytest.mark.parametrize("reps", [1, 4])
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_make_optimizer_num_replicas_matches_jax(scale_lr, reps, schedule):
    """The first AdamW update of a zero leaf under a small gradient, about
    -lr: JAX's optax chain and the port's optimizer, at each combination."""
    kw = dict(learning_rate=1e-4, lr_scheduler=schedule, scale_lr=scale_lr, train_batch_size=2,
              gradient_accumulation_steps=1)
    tx = jidbooth.make_optimizer(jidbooth.IDBoothConfig(**kw), total_steps=10, num_replicas=reps)
    params = {"w": np.zeros((2,), np.float32)}
    grads = {"w": np.full((2,), 1e-3, np.float32)}
    want, _ = tx.update(grads, tx.init(params), params)
    optimizer = idbooth.make_optimizer(idbooth.IDBoothConfig(**kw), total_steps=10, num_replicas=reps)
    w = {"w": torch.zeros(2)}
    optimizer.update([torch.from_numpy(grads["w"])], optimizer.init(w), w)
    np.testing.assert_allclose(w["w"].numpy(), np.asarray(want["w"]), rtol=1e-5)
    assert abs(float(w["w"][0])) == pytest.approx(1e-4 * (2 * reps if scale_lr else 1), rel=1e-3)
