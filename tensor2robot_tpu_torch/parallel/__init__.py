"""Parallelism: so far only the dense attention oracle of
``sequence_parallel``; ring and Ulysses attention are ROADMAP.md queue 1
item 10."""
