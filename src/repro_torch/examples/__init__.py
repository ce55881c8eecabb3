"""The JAX package's three examples on the port, each run as
``python -m repro_torch.examples.<name>`` (on the card by default,
``--device cpu`` on a host without one): ``quickstart``,
``serve_continuous`` and ``train_small``.  Each module's ``main(argv,
params)`` returns what it printed, for tests."""
