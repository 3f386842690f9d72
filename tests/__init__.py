"""The repository's tests: a package, so that ``tests.torch_fleet`` is found
in this checkout before any other top-level ``tests`` on the path."""
