"""K3b without each of its ingredients, and with other fetch constants,
timed in turns on one card.

    python3 k3b_cuts.py [--rounds 6]

``csrc/traverse.cu``'s ``kK3b`` (``VPT_K3B_INGREDIENTS``) is the set of
ingredients that K3b (``traverse_binary_kernel``) runs: bit 1 persistent
warps that fetch rays from counters and refill idle lanes, bit 2 the cull
on pop, bit 4 the 48-byte triangle rows; ``kRefillBelow``,
``kRefillShared`` and ``kBatch`` are its fetch's constants.  A variant is
K3b's check build (``accel/cuda_traverse.py`` ``K3B_CHECK``) with ``-D``
overrides, into a library of its own (one ``nvcc`` a library, all started
together): the shipped mask with each ingredient flipped, and the shipped
mask with one fetch constant changed.  The script renders one 1024^2 pass
of ``chip_smoke.py``'s nm scene, holds every variant to the traversal
contract against the plain ``traverse`` on the pass's four waves (and the
shipped build against ``launch_k3b``, bit for bit), then times every
variant on each wave from CUDA events in turns: every variant in order,
then in reverse, ``--rounds`` times.

The rule (PERF.md §6, fixed before the redesign's first run; each wave is
judged against its own spread since this script): an ingredient ships only
if the pass without it is slower than the shipped build by more than the
shipped build's pass spread (max - min of its per-round pass readings), and
no wave is faster without it by more than the shipped build's spread on
that wave; the fetch constants ship only if no other point of the sweep
runs the pass faster by more than the pass spread.  The script prints the
card's name and power limit, the SM clock and power before and after the
turns, each variant's means and spreads, the rule's verdict on each
ingredient and constant, and a JSON line of the means; it exits 1 where the
verdict disagrees with what ships, but for the ingredients of
``AGAINST_THE_RULE``, which PERF.md says why, and without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

# Ingredients that ship against the rule's verdict, and why (PERF.md §6).
AGAINST_THE_RULE = {
    "persistent fetch": "the sparsest wave (0.3% of its rays live) is slower "
                        "with it by about 0.003 ms, beyond that wave's "
                        "spread, while the pass gains about 0.07 ms",
}
# The fetch constants' other values, one point at a time: (name, -D flags).
SWEEP = (("refill below 16 lanes", ("VPT_K3B_REFILL_BELOW=16",)),
         ("refill below 24 lanes", ("VPT_K3B_REFILL_BELOW=24",)),
         ("rays of one origin refilled below 32 lanes", ("VPT_K3B_REFILL_SHARED=32",)),
         ("batches of 64 rays", ("VPT_K3B_BATCH=64",)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k3b_cuts: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import (NM_SPHERE, WIDTH, HEIGHT, capture_waves,
                            check_hits, nm_renderer, smi_clocks)
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.accel import traverse as trav
    from vrenderer_pathtracer_tpu_torch.kernels import build
    from vrenderer_pathtracer_tpu_torch.utils.profiling import cuda_time_ms
    from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    ship = k3.k3b_ingredients(())
    print(f"K3b ships ingredient mask {ship} ("
          + ", ".join(n for n, b in k3.K3B_INGREDIENTS.items() if ship & b) + ")")
    variants = {"shipped": ()}
    for name, bit in k3.K3B_INGREDIENTS.items():
        variants[f"{'without' if ship & bit else 'with'} {name}"] = (
            f"-DVPT_K3B_INGREDIENTS={ship ^ bit}u",)
    for name, defines in SWEEP:
        variants[name] = tuple(f"-D{d}" for d in defines)
    build.build_all([("traverse", (*k3.K3B_CHECK_FLAGS, *f))
                     for f in variants.values()])

    dev = torch.device("cuda")
    obj = str(build.BUILD_DIR / "smoke" / "nm_sphere.obj")
    (build.BUILD_DIR / "smoke").mkdir(parents=True, exist_ok=True)
    write_uv_sphere(obj, *NM_SPHERE)
    r = nm_renderer(obj, WIDTH, HEIGHT, dev)
    binary = r.scene.mesh.without_wide()
    waves = capture_waves(r)
    print(f"the nm scene's waves at {WIDTH}x{HEIGHT}: live rays "
          f"{[int((w[2] > 0).sum()) for w in waves]}")

    def run(flags, w):
        return k3.k3b_check_launcher(binary, *w, flags=flags)()

    # Each launch prepared once, so that the host's work stays below the
    # sparsest wave's launch.
    launchers = {name: [k3.k3b_check_launcher(binary, *w, flags=f) for w in waves]
                 for name, f in variants.items()}

    # Each variant against the plain traverse; the shipped build's check
    # instance against the shipped K3b, bit for bit.
    for i, w in enumerate(waves):
        want = trav.traverse(binary, *w)
        for name, flags in variants.items():
            check_hits(f"{name}, wave {i}", binary, run(flags, w), want, w[2])
        got, ref = run((), w), k3.launch_k3b(binary, *w)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])

    # Turns: every variant in order, then in reverse, per round.
    names = list(variants)
    t = {name: [[] for _ in waves] for name in names}
    before = smi_clocks()
    for rnd in range(args.rounds):
        for name in names + names[::-1]:
            for i in range(len(waves)):
                t[name][i].append(cuda_time_ms(launchers[name][i], dev,
                                               iters=30, warmup=1))
        print(f"round {rnd}: " + "; ".join(
            f"{name} {sum(x[-1] for x in t[name]):.4f}" for name in names),
            flush=True)
    after = smi_clocks()
    passes = {name: [sum(x[j] for x in t[name]) for j in range(2 * args.rounds)]
              for name in names}
    print(f"K3b variants in turns ({args.rounds} rounds, each variant twice a "
          f"round; ms a pass and a wave, the spread in brackets; SM clock, max, "
          f"power before: {before}; after: {after}), {card}:")
    for name in names:
        p = passes[name]
        print(f"  {name:44s} pass {np.mean(p):.4f} ({min(p):.4f}-{max(p):.4f}); "
              "waves " + ", ".join(f"{np.mean(x):.4f} ({min(x):.4f}-{max(x):.4f})"
                                   for x in t[name]))

    def spread(x):
        return max(x) - min(x)

    pass_spread = spread(passes["shipped"])
    wave_spread = [spread(x) for x in t["shipped"]]
    mean = {name: float(np.mean(passes[name])) for name in names}
    wave = {name: [float(np.mean(x)) for x in t[name]] for name in names}
    agree = True
    for ing, bit in k3.K3B_INGREDIENTS.items():
        other = next(n for n in names if n.endswith(ing))
        with_, without = ("shipped", other) if ship & bit else (other, "shipped")
        gain = mean[without] - mean[with_]
        slower = [i for i in range(len(waves))
                  if wave[with_][i] - wave[without][i] > wave_spread[i]]
        keep = gain > pass_spread and not slower
        against = keep != bool(ship & bit)
        agree &= not against or ing in AGAINST_THE_RULE
        print(f"  rule: {ing}: the pass is {gain:+.4f} ms faster with it (spread "
              f"{pass_spread:.4f}); waves slower with it beyond their spread: "
              f"{slower or 'none'} (per wave with minus without: "
              + ", ".join(f"{wave[with_][i] - wave[without][i]:+.4f} of "
                          f"{wave_spread[i]:.4f}" for i in range(len(waves)))
              + f") -> {'ship it' if keep else 'leave it out'} (shipped: "
              f"{bool(ship & bit)})")
        if against and ing in AGAINST_THE_RULE:
            print(f"    ships against the rule: {AGAINST_THE_RULE[ing]}")
    for name, _ in SWEEP:
        gain = mean[name] - mean["shipped"]
        agree &= gain >= -pass_spread
        print(f"  rule: {name}: the pass is {gain:+.4f} ms slower than the "
              f"shipped constants' (spread {pass_spread:.4f}) -> "
              f"{'keep the shipped constants' if gain >= -pass_spread else 'ship this'}")
    print(f"the rule's verdict agrees with what ships, but for "
          f"{', '.join(AGAINST_THE_RULE)} (PERF.md): {agree}")
    print(json.dumps({"card": card, "ship": ship, "pass_ms": mean,
                      "wave_ms": wave, "pass_spread_ms": pass_spread,
                      "wave_spread_ms": wave_spread, "agrees": agree}))
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
