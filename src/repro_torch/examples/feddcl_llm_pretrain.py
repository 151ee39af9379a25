"""FedDCL's outer tier applied to LLM pretraining: 4 silos (DC-server
groups), H = 4 local steps per FedAvg round, the reduced backbone,
synthetic non-IID token streams: the paper's communication schedule as a
training feature (counterpart of the reference's
``examples/feddcl_llm_pretrain.py``).

  python -m repro_torch.examples.feddcl_llm_pretrain [--steps 80]
      [--device cpu] [--out-dir results_torch]

Writes ``feddcl_llm_pretrain.json`` under the output directory.
"""
import argparse
import os

from repro_torch.benchmarks.common import OUT_DIR
from repro_torch.launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--silos", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)

    _, hist = train(args.arch, reduced=True, steps=args.steps, batch=8,
                    seq=128, silos=args.silos, local_steps=args.local_steps,
                    non_iid=True, device=args.device,
                    log_path=os.path.join(args.out_dir,
                                          "feddcl_llm_pretrain.json"))
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} federated steps "
          f"({args.silos} silos, sync every {args.local_steps})")
    assert last < first, "federated training should reduce loss"
    return hist


if __name__ == "__main__":
    main()
