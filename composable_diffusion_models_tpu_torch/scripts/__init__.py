"""The command lines of the JAX package's ``scripts/``, one module per
script under the script's own name:

    python -m composable_diffusion_models_tpu_torch.scripts.<name> [flags]

Each keeps its script's flags, the ``--key=value`` config overrides, the
files it writes under ``--out`` and its exit codes, and calls the port's
entry points on the CUDA card (``--cpu`` asks for the CPU). Importing a
module runs nothing: its work is in ``main(argv=None)``.
"""
