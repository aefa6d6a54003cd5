"""Multi-rank rendering over torch.distributed on the CPU (gloo ranks).

The image is a pure function of (pixel, sample, dim), so the HDR image and
the ray count of a render over 2 or 3 ranks are bitwise those of one
process, with staged compaction on (an env-lit scene) and off: through
the CLI (`--devices N --device cpu`: this process is rank 0 and spawns
the others), through `--distributed` in two processes given torchrun's
environment, and through `Renderer(devices="all")` in ranks started by
`parallel.distributed.spawn`, where a render resumes from a checkpoint
that rank 0 wrote in a render over other ranks. base_color's loss and
gradient over 2 ranks with `all_reduce_grads` against one process at
tests/test_multihost.py's bar (rtol 1e-6 on the loss; rtol 2e-5, atol
1e-7 on the gradient). Rank workers: tests/torch_dist_worker.py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from yart_tpu_torch import cli
from yart_tpu_torch.io.image import save_hdr
from yart_tpu_torch.parallel import distributed, sharding

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--device", "cpu", "--size", "24x16", "--spp", "4", "--max-depth", "4", "--quiet"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The port on one intra-op thread in this module (tests/test_torch_bsdf.py's docstring)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def sky(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sky") / "sky.hdr")
    y, x = np.mgrid[:8, :16].astype(np.float32)
    save_hdr(path, np.stack([0.2 + 0.1 * x, 0.5 + 0.05 * y, 0.3 + 0.02 * x * y], -1))
    return path


def _scene_args(compaction, sky):
    # An env-lit scene takes staged compaction at depth 2 ("auto"); the
    # closed box none.
    return ["cornell-mat", "--env-hdr", sky] if compaction else ["cornell-mat"]


def _cli_checkpoint(tmp_path, name, argv):
    ck = str(tmp_path / f"{name}.npz")
    assert cli.main(argv + ARGS + ["-o", str(tmp_path / f"{name}.png"), "--checkpoint", ck]) == 0
    with np.load(ck) as z:
        return z["hdr"], float(z["rays"]), int(z["samples_taken"])


def _assert_bitwise(a, b):
    np.testing.assert_array_equal(a[0].view(np.int32), b[0].view(np.int32))
    assert a[1] == b[1] and a[2] == b[2]


@pytest.mark.parametrize("compaction", [False, True], ids=["compaction_off", "compaction_on"])
@pytest.mark.parametrize("ranks", [2, 3])
def test_cli_ranks_bitwise_equal_one_process(tmp_path, sky, ranks, compaction):
    scene = _scene_args(compaction, sky)
    one = _cli_checkpoint(tmp_path, "one", scene)
    many = _cli_checkpoint(tmp_path, "many", scene + ["--devices", str(ranks)])
    assert one[1] > 0 and np.isfinite(one[0]).all() and one[0].mean() > 0
    _assert_bitwise(one, many)
    assert not distributed.is_initialized()  # the CLI left the group it made


def test_cli_distributed_from_torchrun_env(tmp_path):
    """Two processes given torchrun's variables join one group with
    --distributed; rank 0 writes the image and the checkpoint."""
    one = _cli_checkpoint(tmp_path, "one", ["cornell-mat"])
    port = distributed.free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        ck = str(tmp_path / f"tr{r}.npz")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "yart_tpu_torch.cli", "cornell-mat", "--distributed", *ARGS,
             "-o", str(tmp_path / f"tr{r}.png"), "--checkpoint", ck],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode(errors="replace")[-3000:]
    with np.load(str(tmp_path / "tr0.npz")) as z:
        _assert_bitwise(one, (z["hdr"], float(z["rays"]), int(z["samples_taken"])))
    assert (tmp_path / "tr0.png").exists() and not (tmp_path / "tr1.png").exists()
    assert not (tmp_path / "tr1.npz").exists()


def test_renderer_ranks_resume_and_explicit_compaction(tmp_path):
    """Renderer(devices="all") in spawned ranks with compaction (2, 2):
    one wave over 2 ranks writes the checkpoint (rank 0), 3 ranks resume
    from it; the result equals one process's full render bitwise."""
    cfg = dict(samples=6, max_depth=4, first_wave_samples=2, max_wave_samples=4, compact_depth=2,
               compact_factor=2, tonemap="none")
    _, full = W.render(cfg, devices=None)
    ck, out = str(tmp_path / "ck.npz"), str(tmp_path / "out.npz")
    distributed.spawn(W.render_rank, 2, (out, cfg, ck, 1), device="cpu")
    with np.load(out) as z:
        assert int(z["samples"]) == 2 and os.path.exists(ck)
    distributed.spawn(W.render_rank, 3, (out, cfg, ck, None), device="cpu")
    with np.load(out) as z:
        _assert_bitwise((full.hdr, full.total_rays, full.samples_taken),
                        (z["hdr"], float(z["rays"]), int(z["samples"])))


def test_grads_over_two_ranks_match_one_process(tmp_path):
    out = str(tmp_path / "g.npz")
    distributed.spawn(W.grad_rank, 2, (out,), device="cpu")
    loss, grad = W.base_color_loss_grad()
    with np.load(out) as z:
        np.testing.assert_allclose(float(z["loss"]), float(loss), rtol=1e-6)
        np.testing.assert_allclose(z["grad"], grad.numpy(), rtol=2e-5, atol=1e-7)
    assert np.abs(grad.numpy()).max() > 0


def test_rank_parts_and_group_rules(monkeypatch):
    # A chunk's parts: whole PART_ALIGN-pixel parts, the last shorter or empty.
    assert sharding.rank_part(384, 2, 0) == (0, 256) and sharding.rank_part(384, 2, 1) == (256, 384)
    assert [sharding.rank_part(256, 3, r) for r in range(3)] == [(0, 128), (128, 256), (256, 256)]
    assert sharding.rank_part(1000, 1, 0) == (0, 1000)
    # One process: nothing to join.
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_distributed() is False and not distributed.is_initialized()
    assert distributed.local_lane_slice(10) == slice(0, 10)
    # NCCL on CPU ranks, and more NCCL ranks on a host than it has cards.
    with pytest.raises(ValueError, match="CUDA ranks"):
        distributed.check_backend("nccl", "cpu", 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"2 NCCL ranks on a host with 1 CUDA device.*backend='gloo'"):
        distributed.check_backend("nccl", "cuda", 2)
    distributed.check_backend("gloo", "cuda", 2)  # gloo lets ranks share a card
    # An explicit spec that cannot be joined raises.
    with pytest.raises((ValueError, RuntimeError)):
        distributed.init_distributed("bogus://nowhere", 1, 0, device="cpu")
    assert not distributed.is_initialized()
