"""Closed-loop harness and scenario assembly."""
