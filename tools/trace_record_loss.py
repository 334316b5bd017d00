"""Does ``torch.profiler`` lose kernel records of a train step on the card?

Builds ``ARCH`` cut to ``LAYERS`` layers in f32 at ``chip_smoke.py``'s
train shape (batch 8 × 256, its optimiser), takes one step, then profiles
``REPS`` more steps (CUDA activity only, as ``chip_smoke.profiled_step``
does): first with nothing around the step, then with 0.2 s of idle time
inside the capture window before and after it. With ``FILL_MIB`` the card's
free memory is first taken down to that many MiB (the profiler's device
buffers must then come out of what is left).

    PYTHONPATH=src python tools/trace_record_loss.py ARCH LAYERS REPS \
        [FILL_MIB]

Prints one JSON line per profiled step: its wall, the number of device
events in its trace, the first three device starts and last three ends
(µs from the trace's start), the starts of the flash forward kernels, and
the count of each flash kernel by name. A step of one model has the same
kernels every time, so a step whose counts fall short lost records.
Needs a CUDA card.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.device import synchronize  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.train import (DataConfig, TokenStream,  # noqa: E402
                               make_train_step)

GUARD_S = 0.2


def profiled(step, state, batch, dev, guard: float) -> dict:
    synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if guard:
            time.sleep(guard)
        t0 = time.perf_counter()
        step(*state, batch)
        synchronize(dev)
        wall = time.perf_counter() - t0
        if guard:
            time.sleep(guard)
    events = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    flash = sorted(e.time_range.start for e in events
                   if any(k in e.name for k in ("flash_kernel",
                                                "flash_bf16_hopper")))
    return {"guard_s": guard, "wall_ms": wall * 1e3, "n_device": len(events),
            "first_us": sorted(e.time_range.start for e in events)[:3],
            "last_end_us": sorted(e.time_range.end for e in events)[-3:],
            "flash_fwd_start_us": flash,
            "flash_counts": {e.key[:40]: int(e.count)
                             for e in prof.key_averages() if "flash" in e.key}}


def fill_to(dev, leave: int) -> list:
    """Tensors that take the card's free memory down to ``leave`` bytes."""
    fill = []
    for _ in range(64):
        free, _ = torch.cuda.mem_get_info(dev)
        if free <= leave + (64 << 20):
            break
        try:
            fill.append(torch.empty(max(free - leave - (32 << 20), 1 << 20),
                                    dtype=torch.uint8, device=dev))
        except torch.OutOfMemoryError:
            break
    return fill


def main(arch: str, layers: int, reps: int, fill_mib=None) -> None:
    dev = torch.device("cuda")
    FK.library()
    FK.library_bwd()
    cfg = C.train_cfg(arch, layers)
    tcfg = C.train_tcfg()
    state, _ = C.fresh_train_state(dev, cfg, tcfg)
    step = make_train_step(cfg, tcfg)
    stream = TokenStream(DataConfig(vocab=cfg.vocab, seq=C.TRAIN_SEQ,
                                    batch=C.TRAIN_BATCH))
    step(*state, stream.batch(0))
    synchronize(dev)
    guards = (0.0, GUARD_S)
    fill = []
    if fill_mib is not None:
        print(json.dumps({"free_before_fill": torch.cuda.mem_get_info(dev)[0],
                          "reserved": torch.cuda.memory_reserved(dev)}))
        fill = fill_to(dev, fill_mib << 20)
        print(json.dumps({"free_after_fill":
                          torch.cuda.mem_get_info(dev)[0]}))
        guards = (0.0,)
    for guard in guards:
        for _ in range(reps):
            print(json.dumps(profiled(step, state, stream.batch(1), dev,
                                      guard)), flush=True)
    del fill


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0], int(a[1]), int(a[2]), int(a[3]) if len(a) > 3 else None)
