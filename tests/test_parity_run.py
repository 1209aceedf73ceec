"""End-to-end self-test of the weight-parity runner (vdn.cli.parity_run).

Exercises the exact command that will be used on real released
checkpoints (reference eval_depthcrafter/eval.py:254-381 protocol):
random-init reference checkpoint -> torch CPU inference -> convert ->
vdn inference -> depthcrafter metric diff, asserting the two
implementations agree.
"""

import json

from vdn.cli import parity_run


def test_video_self_test(tmp_path):
    out = tmp_path / "report.json"
    rc = parity_run.main(["--self-test", "--family", "video",
                          "--encoder", "vits", "--out", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["load_missing_keys"] == []
    assert report["agreement"]["rel_to_range"] < 2e-2
    for name, row in report["metrics"].items():
        assert abs(row["delta"]) < 1e-3, (name, row)


def test_image_self_test(tmp_path):
    out = tmp_path / "report.json"
    rc = parity_run.main(["--self-test", "--family", "image",
                          "--encoder", "vits", "--out", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["load_missing_keys"] == []
