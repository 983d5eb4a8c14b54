"""Card-only checks of the port (marker ``gpu``; they skip without a CUDA
device): the CUDA ``cascade_score`` against its plain version over
``chip_smoke.py``'s shapes and tolerances, its launch counter, and the main
path on a short stream.  On the card: ``python -m pytest -m gpu
tests/test_torch_gpu.py``."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("case", chip_smoke.KERNEL_CASES)
def test_kernel_matches_plain_version(cuda, case):
    chip_smoke.check_kernel_case(case, cuda, seed=sum(case[:5]))


def test_launch_counter_and_no_fallback(cuda):
    from repro_torch.kernels.proxy_score import cascade_score

    x, (w1, b1, w2, b2), thr, _ = chip_smoke.make_kernel_case(
        (300, 300, 64, 2, 2, "float32", True, None), cuda, seed=0)
    before = cascade_score.launches
    cascade_score(x, w1, b1, w2, b2, thr, 300)
    assert cascade_score.launches == before + 1
    with pytest.raises(ValueError):  # a CUDA tensor the kernel does not take raises
        cascade_score(x.double(), w1, b1, w2, b2, thr, 300)
    assert cascade_score.launches == before + 1


def test_main_path_short_stream(cuda):
    tiles = 3
    _plans, _stream, launches = chip_smoke.run_main_path(cuda, tiles * 8192 + 5)
    assert launches == (tiles + 1) * len(chip_smoke.QUERIES)
