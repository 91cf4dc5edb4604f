"""The port's multi-process pod rehearsal
(`faceposegenerator_tpu_torch/parallel/pod_rehearsal.py`) on the CPU, with
the assertions of JAX's tests/test_pod_rehearsal.py on its verdict.

The port runs a rank a device: `processes` hosts of `local_devices` each
are `processes · local_devices` gloo ranks on the ("data", "model") =
(processes, local_devices) mesh. 2 × 2 (4 ranks: data-parallel across the
hosts, tensor-parallel within each) runs through the command line (`cli
pod-rehearsal --device cpu`, which calls `launch`); it holds every leg of
2 × 1, whose data axis is the same, and adds the model axis. Each rank runs on
one torch thread; the port comes from binding port 0, and a rank that
outlives 120 s fails the run and every rank is killed.
"""

import json

import numpy as np

from faceposegenerator_tpu_torch import cli

TIMEOUT_S = 120


def _check(verdict, processes, local_devices):
    assert verdict["ok"]
    assert verdict["processes"] == processes
    assert verdict["global_devices"] == processes * local_devices
    assert verdict["mesh"] == {"data": processes, "model": local_devices}
    assert np.isfinite(verdict["loss1"]) and np.isfinite(verdict["loss2"])
    # the checkpoint round trip continued training within the worker's own gate
    assert abs(verdict["loss2"] - verdict["loss2_restored"]) < 1e-6
    assert np.isfinite(verdict["sample_mean"])
    assert np.isfinite(verdict["rolling_mean"])


def test_pod_rehearsal_2x2(tmp_path):
    """DP across 2 hosts × TP over 2 local devices: 4 ranks, the UNet's
    sharded blocks split within each host, host_row_slice's 2 row blocks."""
    out = tmp_path / "verdict.json"
    assert cli.main(["pod-rehearsal", "--device", "cpu", "--processes", "2", "--local_devices", "2", "--port", "0",
                     "--timeout", str(TIMEOUT_S), "--out", str(out)]) == 0
    _check(json.loads(out.read_text()), processes=2, local_devices=2)
