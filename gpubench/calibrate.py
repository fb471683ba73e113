"""Readings that set a cell's limits: the compared numbers of sound runs of
the program on many seeds, and of the control on a few.

    python3 gpubench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--control 1]

runs the cell once a seed in this one process (the set-up is paid once)
and prints each run's compared numbers, then the largest of each. With
``--control 1`` the control runs in the program's place: the plain
reference computed with its stages rounded to bfloat16, the nearest
precision below the float32 the configurations state (``ControlDriver``).
The benchmark's own runs never run it. The program's runs here are the
same runs ``run.py`` makes, seed by seed; the lower reading of a limit is
their largest number, the upper the control's smallest.
"""
import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


class ControlDriver:
    """The reference in bfloat16, in the program's place: each request's
    frames (and, for audio traffic, its track) as ``reference`` works them
    out with ``round_to=torch.bfloat16``, from the same per-frame inputs
    (displacement, orbit angle) as the program's driver."""

    def __init__(self, entry, config, traffic, workload, seed, device,
                 mesh_arrays):
        import torch
        from gpubench.harness import check, inputs
        self.check, self.inputs = check, inputs
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.mesh_arrays = check.reference_arrays(mesh_arrays)
        self.per = int(traffic["frames_per_request"])
        self.bf16 = torch.bfloat16
        self.track = None
        if traffic["generator"] == "audio":
            self.window_samples, _ = inputs.audio_window(
                traffic, workload["warmup_requests"], seed)
            self.n = int(traffic["buffer_samples"])

    def warmup(self):
        pass

    def audio(self, frames):
        return self.window_samples[:frames * self.n]

    def frame_inputs(self, first, count):
        return self.inputs.frames(self.traffic, self.config, first, count,
                                  self.seed)

    def request(self, i):
        import torch
        first = i * self.per
        track = None
        if self.traffic["generator"] == "audio":
            need = first + self.per
            if self.track is None or self.track[0].shape[0] < need:
                frames = max(need, 2 * (0 if self.track is None
                                        else self.track[0].shape[0]), 64)
                self.track = self.check.reference_track(
                    self.traffic, self.audio(frames), self.bf16)
            ins = self.check.frame_inputs(first, self.per, self.track)
            track = tuple(torch.from_numpy(t[first:need].copy())
                          for t in self.track)
        else:
            ins = self.frame_inputs(first, self.per)
        frames = torch.stack([self.check.reference_frame(
            self.config, self.mesh_arrays, fi, self.device,
            round_to=self.bf16) for fi in ins])
        return frames, track


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from gpubench.harness import core

    seeds = [int(s) for s in args.seeds.split(",")]
    worst = {}
    for seed in seeds:
        result, _ = core.run(
            ROOT / "BENCHMARK.json", HERE, args.workload, seed, args.seconds,
            False, torch.device("cuda"), time.perf_counter(),
            make_driver=(lambda *a: ControlDriver(*a)) if args.control
            else None)
        numbers = {k: v["value"] for k, v in result["compared"].items()}
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, v), v) if not args.control else \
                min(worst.get(k, v), v)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "numbers": numbers}), flush=True)
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "seeds": len(seeds),
                      "largest" if not args.control else "smallest": worst}))


if __name__ == "__main__":
    sys.exit(main())
