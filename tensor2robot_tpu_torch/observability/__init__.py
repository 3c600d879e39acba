"""Observability: the process metrics registry (``metrics``). Tracing, the
flight recorder and the program ledger wait for ROADMAP queue 1 item 10."""
