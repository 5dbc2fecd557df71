#!/usr/bin/env python3
"""The control of the check that decides `correct`, at a cell's own size.

    python3 benchmark/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

The reference takes the program's place and breaks one guarantee the
configuration states: alpha is drawn from the public inputs alone,
before the commitment (a prover that overlapped the barycentric stage
with the MSMs this way would lose Fiat-Shamir's soundness).  The run is
the harness's own (benchmark/harness.py:run_cell): the same inputs,
drive, comparison and result line, with `ControlProve` handed in as the
prove, so that on a cell over several ranks every rank imports it and
returns the control's proof.  The program's set-up is left out, since
the reference needs none.  For each seed it prints the compared numbers
beside their limits on standard error and the result line on standard
output; `correct` has to read false.  The benchmark's own runs do not
run it.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class ControlProve:
    """prover.prove's signature: the control's proof of the witness it is
    given, for the circuit and trapdoor of (root, workload, seed), which
    it makes again from the seed in the process that calls it."""

    def __init__(self, root: str, workload: str, seed: int):
        self.args = (root, workload, seed)
        self._made = None

    def __call__(self, cache_dir, public_inputs, private_inputs, device=None, group=None):
        from dvpari_tpu_torch.protocol.proof import Proof

        from benchmark import harness
        from benchmark.reference.domain import Domain
        from benchmark.reference.prover import expected_proof

        if self._made is None:
            root, workload, seed = self.args
            inp = harness.make_inputs(harness.load_cell(root, workload), seed)
            self._inp, self._domain, self._made = inp, Domain(inp["circuit"].m), {}
        key = (tuple(public_inputs), private_inputs.tobytes())
        if key not in self._made:
            vals = [1, *public_inputs, *harness.unlimbs(private_inputs)]
            e = expected_proof(self._domain, self._inp["circuit"], vals, self._inp["trapdoor"],
                               bind_challenge=False)
            self._made[key] = Proof(e.commit_p, e.kzg_k, e.a0, e.b0)
        return self._made[key]


def _no_setup(trapdoor, cache, device) -> None:
    """The reference needs no set-up."""


def control_run(root: str, workload: str, seed: int, seconds: float,
                device: str = "cuda") -> dict:
    """harness.run_cell with the control in the program's place."""
    from benchmark import harness

    return harness.run_cell(root, workload, seed, seconds, False, device=device,
                            prove=ControlProve(root, workload, seed), setup=_no_setup)


def main(argv) -> int:
    import argparse

    # by its package's name, so that ranks can import ControlProve
    from benchmark.control import control_run as run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        out = run(ROOT, args.workload, seed, args.seconds)
        print(f"control seed {seed} correct {out['correct']}", file=sys.stderr)
        for name, c in out["checks"].items():
            print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr, flush=True)
        print(json.dumps(dict(out, seed=seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
