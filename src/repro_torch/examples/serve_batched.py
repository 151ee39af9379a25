"""Batched serving of a small model with continuous-batching-lite slots
(counterpart of the reference's ``examples/serve_batched.py``).

  python -m repro_torch.examples.serve_batched --arch gemma2-2b [--device cpu]
"""
from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
