"""The learning demonstrations of the port (the ports of the root
``egs/synthetic_overfit/run.py`` and ``egs/full_pipeline/run.py``): each
builds a synthetic corpus, drives the port's CLIs on it and asserts that
the trained model reaches its quality bar. See ``README.md`` here."""
