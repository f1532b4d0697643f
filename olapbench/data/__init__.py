"""Seeded generators of the benchmark's data: a frame for the program and
the same rows, column by column, for the plain reference."""
