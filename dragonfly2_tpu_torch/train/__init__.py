"""GraphTransformer training (gather mode on the card) and model
artifacts."""
