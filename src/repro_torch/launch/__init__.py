"""Launch layer: the federated training driver."""
