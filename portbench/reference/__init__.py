"""The plain reference: each stage of a chain in plain PyTorch, one file
per op under ``ops/`` (frozen copies of the port's plain forms, with the
compute dtype a parameter), and ``chain.py`` to run a whole chain from the
raw inputs the harness hands to both sides. Nothing here imports the
port, JAX or the JAX package, and nothing takes what the program made."""
