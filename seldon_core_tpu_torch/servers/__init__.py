"""Prepackaged model servers of the port: ``TorchServer`` (counterpart of
the JAX package's ``JAXServer``) and ``GenerateServer`` (continuous-batching
LLM generation). The JAX package's other servers are not ported yet."""
