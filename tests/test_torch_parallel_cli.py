"""The CLI's sharded runs on the CPU: ``run.main([... '--mesh', ...,
'--platform', 'cpu'])`` outside any process group starts the gloo group of
``TIME*SPACE`` ranks itself (``parallel.multihost.launch_cpu_group``) and
returns rank 0's record: the counterpart of ``tests/test_parallel.py``'s
``test_cli_mesh_file_sharded``, a user triangle mesh solved sharded through
the eigenbasis path."""

import numpy as np
import pytest
import torch

from optimal_control_paradiag_torch import run as t_run

torch.set_num_threads(1)


def test_cli_mesh_file_sharded(tmp_path):
    from optimal_control_paradiag_torch import native
    from optimal_control_paradiag_torch.fem.general import boundary_nodes

    if not native.available():
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(0)
    N = 13  # n = 144: divisible by 2 and 4
    pts, tris = native.unit_square_mesh(N, diagonal="left")
    bnd = boundary_nodes(pts.shape[0], tris)
    pts = pts.copy()
    pts[~bnd] += rng.uniform(-0.18 / N, 0.18 / N, size=pts[~bnd].shape)
    mesh_file = str(tmp_path / "mesh.npz")
    np.savez(mesh_file, points=pts, triangles=tris)
    rec = t_run.main([
        "--mesh-file", mesh_file, "--mesh", "4,2", "--method", "woodbury",
        "--nt", "16", "--nx", str(N), "--dtype", "float32",
        "--platform", "cpu", "--out", str(tmp_path),
    ])
    assert rec["residual"] <= 1e-4
    assert rec["mesh"] == {"time": 4, "space": 2, "devices": 8}
    # the eigenbasis route all-gathers nothing
    assert rec["collectives"] == {"all_to_all": 6, "all_reduce": 3}


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "4"], "TIME,SPACE"),
    (["--mesh", "0,2"], "positive"),
    (["--mesh", "2,1", "--platform", "cpu", "--model", "heat", "--method", "spectral"], "heat with --mesh"),
    (["--mesh", "2,1", "--method", "woodbury"], "one per card"),
], ids=["not-a-grid", "empty-axis", "heat-spectral", "no-card"])
def test_cli_mesh_refusals(argv, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        t_run.main(argv + ["--out", str(tmp_path)])
