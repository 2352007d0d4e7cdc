"""The harness: what every cell shares (see ``benchmark/README.md``)."""
