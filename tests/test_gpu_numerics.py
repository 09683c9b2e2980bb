"""The flagship on the card: chip_smoke's flagship and numerics phases as
``gpu`` tests (64-clip bank, 60 s chunks, f64 host references).

They skip without a GPU. On a machine with one, from the repository root:

    APD_GPU_TESTS=1 python -m pytest tests/ -m gpu -q
"""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def flagship_detector(gpu_device, tmp_path_factory):
    """The flagship stream through streaming and the file plan, checked
    against the host reference; the detector it built."""
    d = str(tmp_path_factory.mktemp("flagship"))
    files = chip_smoke.write_patterns(d, chip_smoke.FULL)
    return chip_smoke.phase_flagship(chip_smoke.FULL, files, d)


def test_flagship_stream_matches_host_reference(flagship_detector):
    assert flagship_detector.seconds_per_chunk == chip_smoke.FULL.chunk_seconds


def test_flagship_width_numerics(flagship_detector):
    chip_smoke.phase_numerics(chip_smoke.FULL, flagship_detector)
