"""Model families: the transformer LM and its registry."""
