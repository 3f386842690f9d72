"""Contractions, masks, reduced solves and guesses of the solvers."""
