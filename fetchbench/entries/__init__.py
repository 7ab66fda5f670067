"""Entry kinds: one module a kind, each with a ``Session`` that sets a cell
up, drives one step of the measured window at a time, and hands what the
window produced to the comparison."""
