"""Workload generators for driving the port end to end."""
