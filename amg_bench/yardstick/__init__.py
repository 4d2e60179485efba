"""The yardstick: peaks and the bytes each hand kernel must move."""
