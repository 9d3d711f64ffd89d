"""Prepackaged model servers of the port: ``TorchServer`` (counterpart of
the JAX package's ``JAXServer``: the mlp, resnet50, bert, vit and llm
families of ``models``) and ``GenerateServer`` (continuous-batching LLM
generation). The JAX package's other servers (sklearn, xgboost, mlflow,
tensorflow, triton, sagemaker) are not ported yet."""
