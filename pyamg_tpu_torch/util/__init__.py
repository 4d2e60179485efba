"""Setup-phase utilities of the port."""
