"""The port's runnable examples, one per example of the reference:
``python -m repro_torch.examples.<name> [--device cpu]``. Each parses its
arguments and runs only inside ``main(argv)``, which returns what it
checked."""
