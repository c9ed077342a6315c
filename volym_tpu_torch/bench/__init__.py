"""Benchmark tooling: :mod:`volym_tpu_torch.bench.harness`, the reference
sweep behind the CLI's ``benchmark`` subcommand."""
