"""The repo's ``examples/`` scripts as modules of the port, each run as
``python -m sda_tpu_torch.examples.<name> [--device cpu]``.

Each module has a ``run(device=None, ...) -> dict`` that does what its
script does at the script's sizes and returns what it computed, and a
``main(argv=None)`` that prints the script's lines. Importing one runs
nothing. ``--device`` is CUDA unless ``cpu`` is given; there is no
fallback to the host. See ``README.md`` beside this file.
"""

EXAMPLES = ("federated_http", "streamed_checkpoint", "embedded_participant",
            "fedavg_lenet")
