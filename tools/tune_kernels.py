#!/usr/bin/env python
"""Tune the 3x3 conv's K-split count per shape on the card, and write the
tuning table (``CUDA_TUNE.json`` at the checkout's root).

The port's counterpart of ``bench_pallas.py autotune``. For each 3x3
shape the serving forward launches (``FoldedUNet`` of ``ModelConfig()``
at its 256x256 input, B = 1) it times every split count the bf16
``conv3x3_bn_relu`` launch takes (``ops/tuning.candidates``,
``ops/conv.fwd_plan``'s first): CUDA events around each launch, the
launches queued behind a sleeping kernel so no host gap falls inside a
pair, a warm-up, then the median of ``--launches`` (at least 20). Each
candidate's output is held within BF16_TOL of the plain version. A shape
gets an entry only when its best split beats the heuristic's by more than
GAIN, as the JAX autotuner records; the JAX rule's XLA anchor has no
counterpart here (the table cannot route a launch to cuDNN). It is a
tuning tool, not a benchmark: it writes the table and prints what it
measured. It sweeps at B = 1 only, the batch the serving forward's
launches are keyed for: the table's key has no batch, so the winners of
another batch would land on the serving forward's keys.

Run on the card from a checkout's root:
  python tools/tune_kernels.py [--launches 20] [--dry-run]
Prints one JSON line per shape and the card's name and power limit;
``--dry-run`` writes no table. On a machine without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

#: two bf16 ulps, kernel vs plain from the same operands (chip_smoke's)
BF16_TOL = 1.6e-2
#: a tuned split must beat the heuristic's median by more than this
GAIN = 0.03
MIN_LAUNCHES = 20
#: cycles of the sleeping kernel queued ahead of the timed launches
#: (about 10 ms at the H100's clock: longer than the host takes to queue
#: MIN_LAUNCHES launches)
SLEEP_CYCLES = 20_000_000


def launch_shapes(net, img_size: int) -> list[tuple[int, int, int, int]]:
    """(H, W, Cin, Cout) of each 3x3 launch of the folded forward of
    ``net`` at an ``img_size`` square input, in forward order: the input
    block at full resolution, Down i at 1 / 2^(i+1), Up i back at
    1 / 2^(3-i) (``ops/unet_infer.FoldedUNet``)."""
    def double_conv(dc, level):
        s = img_size >> level
        return [(s, s, *tuple(conv.kernel.shape[2:]))
                for conv in (dc.Conv_0, dc.Conv_1)]

    shapes = double_conv(net.DoubleConv_0, 0)
    for i in range(4):
        shapes += double_conv(getattr(net, f"Down_{i}").DoubleConv_0, i + 1)
    for i in range(4):
        shapes += double_conv(getattr(net, f"Up_{i}").DoubleConv_0, 3 - i)
    return shapes


def serving_shapes() -> list[tuple[int, int, int, int]]:
    """The distinct 3x3 shapes of the serving forward of ``ModelConfig()``
    at ``ServerConfig().model_img_size``, in first-launch order."""
    from robotic_discovery_platform_tpu_torch.models.unet import UNet
    from robotic_discovery_platform_tpu_torch.utils.config import (
        ModelConfig,
        ServerConfig,
    )

    shapes = launch_shapes(UNet(ModelConfig()),
                           ServerConfig().model_img_size)
    return sorted(set(shapes), key=shapes.index)


def median_ms(torch, fn, launches: int = MIN_LAUNCHES) -> float:
    """Median device time of one call of ``fn`` in ms: a warm-up, then
    ``launches`` calls, each between two CUDA events, queued behind a
    sleeping kernel so the card runs them back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(launches)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def sweep(torch, shapes, batch: int = 1, *, relu: bool = True,
          launches: int = MIN_LAUNCHES, seed: int = 0) -> list[dict]:
    """Every candidate split of each (H, W, Cin, Cout) in ``shapes`` at
    ``batch`` frames in bfloat16, timed and checked against the plain
    version; one record per shape: the heuristic split and its ms, the
    best split and its ms, every candidate's ms and its largest error."""
    from robotic_discovery_platform_tpu_torch.ops import conv, tuning

    if not torch.cuda.is_available():
        raise RuntimeError("tune_kernels: no CUDA device; the sweep times "
                           "the kernel on the card")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    records = []
    for h, w, cin, cout in shapes:
        x = torch.randn(batch, h, w, cin, generator=gen, device="cuda").to(bf)
        wt = (torch.randn(3, 3, cin, cout, generator=gen, device="cuda")
              / (9 * cin) ** 0.5).to(bf)
        scale = torch.rand(cout, generator=gen, device="cuda") + 0.5
        bias = torch.randn(cout, generator=gen, device="cuda") * 0.1
        want = conv.conv3x3_bn_relu_plain(x, wt, scale, bias, relu=relu)
        ms, errs = {}, {}
        for splits in tuning.candidates(h, w, cin, cout):
            def launch(splits=splits):
                return conv.conv3x3_bn_relu(x, wt, scale, bias, relu=relu,
                                            splits=splits)

            got = launch()
            torch.cuda.synchronize()
            errs[splits] = float((got.float() - want.float()).abs().max())
            if not torch.allclose(got.float(), want.float(), atol=BF16_TOL,
                                  rtol=BF16_TOL):
                raise AssertionError(
                    f"conv3x3_bn_relu {(batch, h, w, cin, cout)} at "
                    f"{splits} splits: max |err| {errs[splits]} over "
                    f"{BF16_TOL}")
            ms[splits] = median_ms(torch, launch, launches)
        heuristic = conv.fwd_plan(batch, h, w, cin, cout)[0]
        best = min(ms, key=ms.get)
        records.append({
            "shape": [batch, h, w, cin, cout], "heuristic": heuristic,
            "heuristic_ms": ms[heuristic], "best": best,
            "best_ms": ms[best], "ms": ms, "max_abs_err": max(errs.values()),
        })
    return records


def entries(records: list[dict]) -> dict:
    """The table's entries: a shape whose best split beats the
    heuristic's by more than GAIN, keyed as ``ops/tuning.key``."""
    from robotic_discovery_platform_tpu_torch.ops import tuning

    out = {}
    for r in records:
        _, h, w, cin, cout = r["shape"]
        if (r["best"] != r["heuristic"]
                and r["best_ms"] < r["heuristic_ms"] * (1.0 - GAIN)):
            out[tuning.key(h, w, cin, cout)] = {
                "splits": r["best"], "ms": r["best_ms"],
                "heuristic_ms": r["heuristic_ms"]}
    return out


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--launches", type=int, default=MIN_LAUNCHES)
    parser.add_argument("--dry-run", action="store_true",
                        help="print the sweep, write no table")
    args = parser.parse_args(argv)
    if args.launches < MIN_LAUNCHES:
        parser.error(f"--launches takes at least {MIN_LAUNCHES}")
    import torch

    from robotic_discovery_platform_tpu_torch.ops import tuning

    records = sweep(torch, serving_shapes(), launches=args.launches)
    for r in records:
        print(json.dumps(r), flush=True)
    card = card_line()
    print(card, flush=True)
    if not args.dry_run:
        path = tuning.save_entries(entries(records), {
            "device": torch.cuda.get_device_name(0), "card": card,
            "launches": args.launches,
            "torch": torch.__version__, "cuda": torch.version.cuda})
        print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
