"""The port's serving_bench.py and eval_pipeline_bench.py (the JAX package's
tools of those names) at their --nano geometry on the CPU, in-process, each
printing the JAX tool's one JSON line: its keys, the values it returns.
"""
import json

from open_groundingdino_tpu_torch.tools import eval_pipeline_bench, serving_bench


def test_serving_bench_nano(capsys):
    args = serving_bench.get_args_parser().parse_args(
        ["--nano", "--device", "cpu", "--iters", "1"])
    line = serving_bench.run(args)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert {"metric", "aot_latency_ms", "aot_img_s", "first_call_s", "export_s", "artifact_mb",
            "bucket", "batch", "platform"} <= set(line)
    assert line["bucket"] == "64x96" and line["aot_latency_ms"] > 0


def test_eval_pipeline_bench_nano(capsys):
    args = eval_pipeline_bench.get_args_parser().parse_args(
        ["--nano", "--images", "2", "--batch", "2", "--fwd_iters", "1", "--device", "cpu"])
    line = eval_pipeline_bench.run(args)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert {"metric", "pipeline_img_s", "raw_fwd_img_s", "ratio", "images", "batch",
            "device_resident", "platform"} <= set(line)
    assert line["pipeline_img_s"] > 0 and line["raw_fwd_img_s"] > 0
