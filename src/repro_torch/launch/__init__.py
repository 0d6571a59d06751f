"""LM launchers: the serving steps and the batched decode server."""
