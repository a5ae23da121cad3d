"""Two processes on `torch.distributed` (gloo over localhost): the port's
`parallel/multihost.py` and the sharded paths across processes, as
tests/test_multihost2.py runs the JAX package's.

This file is also the worker: the test starts it twice as a script
(argv: port, rank, output directory).  Each rank contributes 4 CPU
positions to one global layout of 8, rank-major, and checks:

  * `multihost.init` (gloo, a time limit on every collective), `sync`,
    `is_primary`, and the global (4, 2) mesh's ranks (INIT_OK);
  * `render_sharded` (the RGB kernel's plain version) over the (4, 2)
    layout, whose tile axis spans both ranks, gathered to rank 0 by
    `gather_to_host0` (GATHER_OK; the other rank gets None);
  * a (1, 8) layout, whose spp merge is the cross-process all-reduce: the
    merged frame on both ranks (PSUM_OK);
  * one `train_step_sharded` step (recorded marches) over the (4, 2)
    layout: the loss printed (TRAIN_LOSS), the updated leaves saved.

The parent holds rank 0's gathered image to the one-process render of
the same layout byte for byte (each tile's two samples slices live on one
rank, so the all-reduce adds only zeros), the (1, 8) frames of both ranks
to each other byte for byte and to the one-process render within the
re-associated sum's bar (rtol 1e-5 / atol 1e-6), both ranks' losses to
each other exactly and to the one-process step's to 1e-6, and the
updated leaves to the one-process step's within 1e-5 * max|g| (lr 1).
It skips, as the JAX test does, only when the socket is refused.  No JAX
here: the workers import torch and the port only.
"""
import os
import socket
import subprocess
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CFG = dict(width=16, height=16, max_steps=128, max_bounces=2,
            max_dist=100.0)
_TIMEOUT_S = 300


def _setup():
    import torch
    from raymarchrenderer_tpu_torch.core.camera import Camera
    from raymarchrenderer_tpu_torch.render.config import RenderConfig
    from raymarchrenderer_tpu_torch.scene import builtin
    torch.set_num_threads(1)
    scene = builtin.sphere_on_floor()
    target = torch.from_numpy(np.random.RandomState(7).uniform(
        0.0, 0.5, (16, 16, 3)).astype(np.float32))
    return (scene, scene.init_params("cpu"), RenderConfig(**_CFG),
            Camera(aspect=1.0).corner_rays_flat("cpu"), target)


def _worker(port: int, rank: int, out: str) -> int:
    import torch
    from raymarchrenderer_tpu_torch.parallel import multihost
    from raymarchrenderer_tpu_torch.parallel import sharding
    from raymarchrenderer_tpu_torch.scene import params_to_numpy
    try:
        active = multihost.init(f"127.0.0.1:{port}", 2, rank,
                                backend="gloo", timeout_s=120)
    except Exception as e:  # noqa: BLE001 - told apart below
        if isinstance(e, (ConnectionRefusedError, PermissionError)) or \
                "refused" in str(e).lower():
            print(f"INIT_UNAVAILABLE: {type(e).__name__}: {e}", flush=True)
            return 3
        raise
    assert active and multihost.process_count() == 2
    assert multihost.is_primary() == (rank == 0)
    multihost.sync()
    cpu4 = [torch.device("cpu")] * 4
    mesh = sharding.make_mesh(sharding.ShardConfig(4, 2), cpu4)
    assert mesh.ranks == ((0, 0), (0, 0), (1, 1), (1, 1)), mesh.ranks
    assert mesh.rank == rank and len(mesh.local_positions()) == 4
    print("INIT_OK", flush=True)

    scene, params, cfg, corners, target = _setup()
    img = sharding.render_sharded(scene, params, cfg, corners, 4,
                                  impl="fused", mesh=mesh)
    full = multihost.gather_to_host0(img)
    if rank == 0:
        assert full is not None and full.shape == (16, 16, 3)
        np.save(os.path.join(out, "gather.npy"), full)
        print("GATHER_OK", flush=True)
    else:
        assert full is None
    multihost.sync()

    mesh8 = sharding.make_mesh(sharding.ShardConfig(1, 8), cpu4)
    img8 = sharding.render_sharded(scene, params, cfg, corners, 8,
                                   impl="fused", mesh=mesh8)
    np.save(os.path.join(out, f"psum{rank}.npy"), img8.numpy())
    print("PSUM_OK", flush=True)

    loss, new_params = sharding.train_step_sharded(
        scene, params, cfg, corners, target, 2, lr=1.0,
        march_impl="recorded", mesh=mesh)
    np.savez(os.path.join(out, f"train{rank}.npz"),
             *params_to_numpy(new_params))
    print(f"TRAIN_LOSS {float(loss):.9e}", flush=True)
    multihost.sync()
    multihost.shutdown()
    print("ALL_OK", flush=True)
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo(tmp_path):
    import pytest
    import torch
    from raymarchrenderer_tpu_torch.parallel import sharding
    from raymarchrenderer_tpu_torch.scene import param_leaves
    env = dict(os.environ, PYTHONPATH=_REPO, CUDA_VISIBLE_DEVICES="")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(i),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=_REPO) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("workers timed out:\n" + "\n---\n".join(outs))
    if any("INIT_UNAVAILABLE" in o for o in outs):
        pytest.skip("the localhost socket was refused: "
                    + outs[0].splitlines()[-1][:200])
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} rc={p.returncode}:\n{out}"
        assert "INIT_OK" in out and "PSUM_OK" in out and "ALL_OK" in out, \
            f"worker {i}:\n{out}"
    assert "GATHER_OK" in outs[0] and "GATHER_OK" not in outs[1]
    losses = [next(ln for ln in o.splitlines() if ln.startswith("TRAIN_LOSS"))
              for o in outs]
    assert losses[0] == losses[1], losses

    scene, params, cfg, corners, target = _setup()
    cpu8 = [torch.device("cpu")] * 8
    want = sharding.render_sharded(
        scene, params, cfg, corners, 4, impl="fused",
        mesh=sharding.make_mesh(sharding.ShardConfig(4, 2), cpu8))
    np.testing.assert_array_equal(np.load(tmp_path / "gather.npy"),
                                  want.numpy())
    want8 = sharding.render_sharded(
        scene, params, cfg, corners, 8, impl="fused",
        mesh=sharding.make_mesh(sharding.ShardConfig(1, 8), cpu8))
    got8 = [np.load(tmp_path / f"psum{i}.npy") for i in range(2)]
    np.testing.assert_array_equal(got8[0], got8[1])
    np.testing.assert_allclose(got8[0], want8.numpy(), rtol=1e-5, atol=1e-6)
    loss, grads = sharding.train_grads_sharded(
        scene, params, cfg, corners, target, 2, march_impl="recorded")
    np.testing.assert_allclose(float(losses[0].split()[1]), float(loss),
                               rtol=1e-6)
    saved = [np.load(tmp_path / f"train{i}.npz") for i in range(2)]
    for k, (p0, g) in enumerate(zip(param_leaves(params),
                                    param_leaves(grads))):
        a, b = saved[0][f"arr_{k}"], saved[1][f"arr_{k}"]
        np.testing.assert_array_equal(a, b)
        if g.numel():
            tol = 1e-5 * float(g.abs().max()) + float(
                np.spacing(np.abs(p0.numpy()).max().astype(np.float32)))
            np.testing.assert_allclose(p0.numpy().astype(np.float64) - a,
                                       g.numpy(), rtol=0, atol=tol)


if __name__ == "__main__":
    sys.exit(_worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))
