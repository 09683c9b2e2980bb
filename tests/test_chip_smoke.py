"""chip_smoke.py's phases at tiny size on the CPU.

The script itself only passes on a GPU; here each phase runs with a
small bank and short chunks so its checks (and the comparisons they
make against the host references) are exercised on every test run.
"""

import json

import pytest

import chip_smoke
from chip_smoke import Flagship

TINY = Flagship(n_normal=2, n_marker=2, chunk_seconds=4, n_chunks=2)


@pytest.fixture(scope="module")
def tiny_patterns(tmp_path_factory):
    d = tmp_path_factory.mktemp("patterns")
    return str(d), chip_smoke.write_patterns(str(d), TINY)


@pytest.fixture(scope="module")
def tiny_detector(tiny_patterns):
    d, files = tiny_patterns
    return chip_smoke.phase_flagship(TINY, files, d)


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_fails_without_gpu(argv, capsys):
    import jax

    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")
    assert chip_smoke.main(argv) == 1
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "not 'gpu'" in out.err


def test_device_phase_reports_platform():
    import jax

    info = chip_smoke.phase_device(require_gpu=False)
    assert info["platform"] == jax.devices()[0].platform
    assert info["count"] == len(jax.devices())


def test_result_line_contract():
    line = chip_smoke.result_line({"platform": "gpu", "kind": "H100", "count": 1})
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "H100", "count": 1},
    }


def test_uploads_phase(capsys):
    chip_smoke.phase_uploads()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[uploads] ")
    fields = json.loads(line[len("[uploads] "):])
    assert fields["came_back_as_itself"] == {
        "int32": True, "bool": True, "int16": True,
    }


def test_corpus_phase():
    chip_smoke.phase_corpus()


def test_flagship_phase_matches_host(tiny_detector):
    assert tiny_detector.seconds_per_chunk == TINY.chunk_seconds


def test_numerics_phase(tiny_detector):
    chip_smoke.phase_numerics(TINY, tiny_detector)


def test_serve_phase(tiny_patterns):
    _, files = tiny_patterns
    chip_smoke.phase_serve(TINY, files, n_clients=2, n_chunks=2)


def test_four_phase_on_virtual_devices(tmp_path):
    chip_smoke.phase_four(TINY, str(tmp_path))


def test_check_hits_rejects_stray_and_missing_events():
    hits = [("normal_0", 1.0, 1.0), ("marker_0", 3.0, 0.25)]
    dur = {"normal_0": 1.0, "normal_1": 1.0, "marker_0": 0.25, "marker_1": 0.25}
    # marker_1 fires 34 ms before the marker_0 hit: a neighbour tone.
    good = {("normal_0", 1000), ("marker_0", 3000), ("marker_1", 2966)}
    assert chip_smoke.check_hits(good, hits, dur, "t") == 1
    with pytest.raises(chip_smoke.SmokeFailure, match="on no embedded hit"):
        chip_smoke.check_hits(good | {("normal_1", 7000)}, hits, dur, "t")
    with pytest.raises(chip_smoke.SmokeFailure, match="on no embedded hit"):
        chip_smoke.check_hits(good | {("marker_1", 3300)}, hits, dur, "t")
    with pytest.raises(chip_smoke.SmokeFailure, match="another clip"):
        chip_smoke.check_hits(good | {("normal_1", 1000)}, hits, dur, "t")
    with pytest.raises(chip_smoke.SmokeFailure, match="not found"):
        chip_smoke.check_hits({("normal_0", 1000)}, hits, dur, "t")
