"""The vision tower's forward FLOPs per crop times the crops of the
window's groups, over those groups' host time (the profiled groups left
out) and the float32-accurate peak (165 TFLOP/s), in %."""


def read(ctx):
    calls = ctx.get("call_s") if ctx.get("kind") == "zeroshot_eval" else None
    if not calls:
        return None
    crops = len(calls) * ctx["images_per_call"] * ctx["crops_per_image"]
    return 100.0 * ctx["crop_flops"] * crops / sum(calls) / ctx["peak_flops"]
