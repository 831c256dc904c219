"""Stage tracing."""

from pngloss_jax import tracing


def test_stage_accumulation():
    tracing.snapshot(reset=True)
    with tracing.stage("x"):
        pass
    with tracing.stage("x"):
        pass
    snap = tracing.snapshot(reset=True)
    assert snap["x"]["calls"] == 2
    assert snap["x"]["seconds"] >= 0


def test_pipeline_traces_stages(suite_dir):
    from pngloss_jax.pipeline import compress_many
    tracing.snapshot(reset=True)
    rose = open(f"{suite_dir}/rose.png", "rb").read()
    compress_many([rose], strength=19)
    snap = tracing.snapshot(reset=True)
    assert snap["host_decode"]["calls"] == 1
    assert snap["host_encode"]["calls"] == 1
    assert any(k.startswith("device_dispatch_") for k in snap)
    assert snap["device_fetch"]["calls"] == 1
