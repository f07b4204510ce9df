"""Hardening tools of the port: ``fuzz_parsers`` (the coverage-guided
fuzzer of the parsers, with its corpus under ``corpus/``) and
``differential`` (the card's decode against the CPU's on seeded
mutants)."""
