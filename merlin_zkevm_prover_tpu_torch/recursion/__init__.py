"""Recursion stages: gate circuits, the plonk12c lowering, the in-circuit
STARK verifier and the reusable recursive1 / recursive2 stage."""
