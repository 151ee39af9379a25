"""PyTorch/CUDA port of the FedDCL reference package ``repro``.

Module paths and public names mirror ``repro`` so each counterpart is found
at once (``repro.core.collab`` -> ``repro_torch.core.collab``). The package
imports ``torch`` and numpy only. Entry points run on CUDA unless the caller
passes ``device="cpu"`` (see ``repro_torch.device``).
"""
