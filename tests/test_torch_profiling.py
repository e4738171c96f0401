"""The port's profiling helpers (maua_tpu_torch/profiling.py) against maua_tpu's.

The analytic FLOP counts are integer arithmetic over the configs, so they must equal maua_tpu's exactly on the
same configurations; `compiled_flops` counts what torch dispatches (FlopCounterMode), held here against the
analytic count of a StyleGAN2 frame; `mfu` divides by the H100's data-sheet peaks.
"""

import json
import time

import pytest
import torch

from maua_tpu import profiling as JP
from maua_tpu.diffusion.models import unet as JU
from maua_tpu.gan import discriminator as JD
from maua_tpu.gan import stylegan2 as J2
from maua_tpu.gan import stylegan3 as J3
from maua_tpu.super.models import rrdbnet as JR
from maua_tpu_torch import profiling as TP
from maua_tpu_torch.diffusion.models import unet as TU
from maua_tpu_torch.gan import discriminator as TD
from maua_tpu_torch.gan import stylegan2 as T2
from maua_tpu_torch.gan import stylegan3 as T3
from maua_tpu_torch.super.models import rrdbnet as TR

SG2_CASES = [{}, {"img_resolution": 256, "channel_max": 256}, {"img_resolution": 64, "channel_base": 1024,
                                                                 "channel_max": 64}]


@pytest.mark.parametrize("kw", SG2_CASES, ids=["config-f", "256", "64"])
def test_stylegan_flops_equal_maua_tpus(kw):
    assert TP.sg2_frame_flops(T2.SG2Config(**kw)) == JP.sg2_frame_flops(J2.SG2Config(**kw))
    res = kw.get("img_resolution", 1024)
    d = {"img_resolution": res, **({"channel_max": kw["channel_max"]} if "channel_max" in kw else {})}
    assert TP.d2_forward_flops(TD.D2Config(**d)) == JP.d2_forward_flops(JD.D2Config(**d))
    assert TP.gan_train_step_flops(T2.SG2Config(**kw), TD.D2Config(**d), 4) == \
        JP.gan_train_step_flops(J2.SG2Config(**kw), JD.D2Config(**d), 4)


def test_other_flop_counts_equal_maua_tpus():
    for hw in (32, 64, 96):
        assert TP.unet_step_flops(TU.SD1_UNET, hw) == JP.unet_step_flops(JU.SD1_UNET, hw)
    assert TP.unet_step_flops(TU.SD1_UNET, 64, context_len=10) == JP.unet_step_flops(JU.SD1_UNET, 64, context_len=10)
    assert TP.sg3_frame_flops(T3.SG3Config()) == JP.sg3_frame_flops(J3.SG3Config())
    small = {"img_resolution": 256, "channel_base": 8192, "channel_max": 256}
    assert TP.sg3_frame_flops(T3.SG3Config(**small)) == JP.sg3_frame_flops(J3.SG3Config(**small))
    for h, w in ((64, 64), (61, 75)):
        assert TP.rrdb_flops(TR.RRDBConfig(), h, w) == JP.rrdb_flops(JR.RRDBConfig(), h, w)
    assert TP.rrdb_flops(TR.RRDBConfig(scale=2), 32, 32) == JP.rrdb_flops(JR.RRDBConfig(scale=2), 32, 32)


def test_stage_timer_counts_and_reports():
    timer = TP.StageTimer()
    for _ in range(3):
        with timer.stage("decode"):
            time.sleep(0.002)
    with timer.stage("encode"):
        pass
    assert timer.counts == {"decode": 3, "encode": 1}
    assert timer.totals["decode"] >= 0.006
    lines = timer.report().splitlines()
    assert lines[1].split()[:3] == ["decode", f"{timer.totals['decode']:.3f}", "3"] and lines[2].startswith("encode")
    with pytest.raises(ZeroDivisionError):  # an error inside a stage is not swallowed, and the stage still counts
        with timer.stage("bad"):
            1 / 0
    assert timer.counts["bad"] == 1


def test_mfu_uses_the_h100_peaks():
    assert TP.H100_PEAK_TFLOPS["bfloat16"] == 989.0 and TP.H100_PEAK_TFLOPS["float32"] == 67.0
    assert TP.H100_PEAK_TFLOPS["tf32"] == 495.0
    assert TP.mfu(989e12, 1.0) == pytest.approx(1.0)
    assert TP.mfu(67e12, 2.0, "float32") == pytest.approx(0.5)
    assert TP.mfu(495e12, 1.0, "tf32") == pytest.approx(1.0)
    assert TP.mfu(989e12, 1.0, "unknown") == pytest.approx(1.0)


def test_compiled_flops_counts_a_stylegan2_frame():
    """FlopCounterMode counts what one frame dispatches: the analytic count prices each block's up conv at its
    output resolution, where the port runs it transposed at its input resolution (a quarter of the work); with
    that, the count lies within 10 % above the analytic one (the FIR and affine layers on top)."""
    cfg = T2.SG2Config(img_resolution=32, channel_base=512, channel_max=64, z_dim=32, w_dim=32, mapping_layers=2)
    params = T2.init_params(cfg, torch.Generator().manual_seed(0))
    ws = torch.randn(1, cfg.num_ws, cfg.w_dim, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        counted = TP.compiled_flops(T2.synthesis, params, ws, cfg, noise_mode="const")
    up = sum(2 * r * r * cfg.channels(r // 2) * cfg.channels(r) * 9 for r in cfg.block_resolutions if r > 4)
    analytic = TP.sg2_frame_flops(cfg) - 0.75 * up
    assert analytic <= counted <= 1.1 * analytic, (counted, analytic)
    assert TP.compiled_flops(torch.matmul, torch.ones(4, 8), torch.ones(8, 3)) == 2 * 4 * 8 * 3


def test_trace_writes_a_chrome_trace(tmp_path):
    with TP.trace(str(tmp_path / "t")) as d:
        with TP.annotate("codec_encode"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert d == str(tmp_path / "t") and any(e.get("name") == "codec_encode" for e in events)
