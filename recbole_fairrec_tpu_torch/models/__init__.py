"""Recommender models of the port (resolved by name via utils.get_model)."""
