"""The int8 engine's accuracy cell, on the port (`tools/int8_quality_cell.py`
of lfdtpu): train one zoo WIDERFACE model (XS/S/M/L) on the synthetic set
(tools/synthetic_e2e.py, single class), then score the trained weights
through the fp32 engine, the bf16 engine with the hand-written convs, and
the int8 engine (calibrated on training frames) with a float32 and with a
bf16 head, and report each engine's mAP_50 and the int8 delta.

Prints one `QUALITY_RESULT {json}` line with lfdtpu's keys (model, epochs,
mAP_50_predict, mAP_50_fp32_engine, mAP_50_int8_engine, int8_delta,
total_s) and mAP_50_bf16_engine, mAP_50_int8_bf16_engine and `card` (the
name and power limit nvidia-smi gives, beside total_s).

    python -m lfdtpu_torch.tools.int8_quality_cell WIDERFACE-L [epochs]
"""

from __future__ import annotations

import argparse
import json
import time

from lfdtpu_torch.tools.synthetic_e2e import run_synthetic

PRECISIONS = ("fp32", "bf16", "int8", "int8_bf16")
# threshold 0.2 gates only "did it learn at all": the cell's product is the
# engines' delta against fp32, which means something whenever the fp32 engine
# detects; the absolute synthetic mAP of a zoo model after 60 short epochs
# from scratch is not the claim
THRESHOLD = 0.2


def quality_cell(model, epochs=60, device=None, on_engine=None):
    """Train and score `model`; returns the QUALITY_RESULT dict."""
    from lfdtpu_torch.execution.utils import _card_line

    t0 = time.time()
    m = run_synthetic(epochs=epochs, threshold=THRESHOLD, zoo_model=model,
                      engine_quality=True, device=device, precisions=PRECISIONS,
                      on_engine=on_engine)
    q = m["engine_mAP_50"]
    total_s = time.time() - t0
    return dict(
        model=model, epochs=epochs,
        mAP_50_predict=round(float(m.get("mAP_50", 0.0)), 4),
        mAP_50_fp32_engine=round(q["fp32"], 4),
        mAP_50_int8_engine=round(q["int8"], 4),
        int8_delta=round(q["fp32"] - q["int8"], 4),
        mAP_50_bf16_engine=round(q["bf16"], 4),
        mAP_50_int8_bf16_engine=round(q["int8_bf16"], 4),
        total_s=round(total_s, 1),
        card=_card_line() if str(device or "cuda").startswith("cuda") else "cpu",
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("model", help="a zoo key, e.g. WIDERFACE-L")
    ap.add_argument("epochs", type=int, nargs="?", default=60)
    ap.add_argument("--device", default=None, help="default: the card ('cuda')")
    args = ap.parse_args(argv)
    print("QUALITY_RESULT " + json.dumps(quality_cell(args.model, args.epochs, args.device)))


if __name__ == "__main__":
    main()
