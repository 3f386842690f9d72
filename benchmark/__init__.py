"""The port's benchmark (see README.md): one cell run once by run.py."""
