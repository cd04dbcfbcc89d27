"""The JAX package's scripts under ``scripts/``, ported: one module per
script, of the same name, with its config dataclass (the same fields and
defaults; a ``platform: "cpu" | "default"`` field becomes ``device: "cpu" |
"cuda"``, defaulting to ``"cuda"``) and a ``main()`` on ``configs/cli.py``::

    python -m perseus_tpu_torch.tools.<name> [--flags]

Each module keeps a compute half that writes no PNG, TIFF or HDF5 beside
its writer, so that it runs where ``h5py``, ``PIL`` and ``matplotlib`` are
missing (the card's machine). Every entry point runs on the CUDA card
unless the caller passes ``device="cpu"``, and raises without CUDA.
"""
