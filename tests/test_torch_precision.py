"""The port's one fp32 policy (``utils/precision.py``): each entry point
(``inference/cli.py``, ``inference/server.py``, ``training/run.py`` and
``Real3DPortraitPipeline``) turns TF32 off for cuDNN and cuBLAS before any
work, and the tools that time or check the card call the same function
instead of setting the flags themselves. The heavy part of each entry point
is replaced by a stub: the flags are read where it would start."""

import os

import pytest
import torch

from real3dportrait_tpu_torch.inference import cli, pipeline, server
from real3dportrait_tpu_torch.training import run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ["chip_smoke.py", "real3dportrait_tpu_torch/inference/run_times.py",
         "real3dportrait_tpu_torch/inference/profile_frame.py",
         "real3dportrait_tpu_torch/inference/kernel_times.py",
         "real3dportrait_tpu_torch/inference/k7_shapes.py",
         "real3dportrait_tpu_torch/training/profile_step.py",
         "tests/test_torch_kernels_cuda.py"]


class Started(Exception):
    """Raised by a stub where the entry point's work would begin."""


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.fixture
def tf32_on():
    saved = _flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _raise(*a, **k):
    raise Started


@pytest.mark.parametrize("entry", ["cli", "server", "run", "pipeline"])
def test_entry_point_sets_the_fp32_policy(entry, tf32_on, monkeypatch, tmp_path):
    assert _flags() == (True, True)
    if entry == "cli":
        monkeypatch.setattr(cli, "pipeline_from_args", _raise)
        call = lambda: cli.main(["--src_img", "x.png", "--drv_aud", "x.wav",  # noqa: E731
                                 "--device", "cpu"])
    elif entry == "server":
        monkeypatch.setattr(server, "serve", _raise)
        call = lambda: server.main(["--device", "cpu"])  # noqa: E731
    elif entry == "run":
        monkeypatch.setattr(run, "make_trainer", _raise)
        call = lambda: run.main(["--config", "x.yaml", "--device", "cpu"])  # noqa: E731
    else:
        monkeypatch.setattr(pipeline, "entry_device", _raise)
        call = lambda: pipeline.Real3DPortraitPipeline(device="cpu")  # noqa: E731
    with pytest.raises(Started):
        call()
    assert _flags() == (False, False)


@pytest.mark.parametrize("path", TOOLS)
def test_tools_call_the_policy(path):
    src = open(os.path.join(ROOT, path)).read()
    assert "set_fp32_policy()" in src
    assert "allow_tf32 =" not in src
