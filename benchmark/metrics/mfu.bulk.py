"""mfu.bulk: the model FLOPs of the work completed in the traced window (the
reference's count, harness/counts.py) over the window times the chip's
bf16 dense peak, in %."""


def read(data):
    per = data.get("flops_per_image")
    done = data.get("images_done")
    if not per or not done:
        return None
    return 100.0 * done * per / (data["window_s"] * data["peaks"]["bf16_flops"])
