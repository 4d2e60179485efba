"""Krylov loops of the port: preconditioned CG."""
