"""seldon_core_tpu_torch: the serving stack of ``seldon_core_tpu``, ported
to PyTorch and CUDA for an NVIDIA H100.

A package of its own beside the JAX package, which stays the reference
it is held against. It imports ``torch`` and never ``jax``, and nothing of
``seldon_core_tpu``. Module paths mirror the JAX package's:

  * wire contract                      (`proto/`, `payload`)
  * microservice runtime (REST, gRPC,  (`user_model`, `seldon_methods`,
    FBS; workers, persistence)          `wrapper`, `http_server`,
                                        `microservice`, `fbs`,
                                        `persistence`, `openapi`)
  * inference-graph engine             (`graph/`, `engine_main`)
  * request logging, async ingestion   (`request_logging`, `ingest`)
  * deadlines, retries, breakers,
    fault injection                    (`resilience/`)
  * spans and device ranges            (`tracing`)
  * prepackaged servers                (`servers/torchserver`,
                                        `servers/generateserver`)
  * continuous-batching generate       (`serving/continuous`; the disagg
                                        transports `serving/disagg`, the
                                        host KV tier `serving/kvtier`, live
                                        migration `serving/migration`,
                                        tenants `serving/weightpager`)
  * the Llama-style decoder            (`models/llm`)
  * the parallel training step, MoE    (`parallel/`: mesh, collectives,
                                        ring attention, GPipe, experts,
                                        `make_train_step`)
  * hand-written CUDA kernels          (`ops/`)
  * JAX's threefry PRNG, bit for bit   (`rng`)
  * weights from the JAX package       (`convert`)

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
