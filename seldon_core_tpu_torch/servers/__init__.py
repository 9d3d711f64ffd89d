"""Prepackaged model servers of the port, the JAX package's eight:
``TorchServer`` (counterpart of ``JAXServer``: the mlp, resnet50, bert,
vit, llm, retrieval and reranker families of ``models``) and
``GenerateServer`` (continuous-batching LLM generation) on the card;
``SKLearnServer``, ``XGBoostServer``, ``MLFlowServer``, ``TFServer``,
``TRTServer`` (a Triton proxy) and ``SageMakerServer`` (an endpoint
proxy) on the host. A server whose library is missing raises a clear
error naming it on load."""
