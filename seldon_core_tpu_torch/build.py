"""Wrapper build automation: user code -> servable image context.

Counterpart of ``seldon_core_tpu/build.py`` and of the reference's s2i
builder images (reference: wrappers/s2i/python/s2i/bin/assemble —
requires MODEL_NAME / API_TYPE / SERVICE_TYPE / PERSISTENCE env vars,
installs requirements, launches the microservice; wrappers/s2i/java/ for
JVM components). Redesigned without the s2i toolchain: ``sdctl build``
materialises a plain docker build context — Dockerfile + user source +
the same four contract env vars — that any builder (docker, kaniko,
buildpacks CI) can consume, and optionally invokes ``docker build`` when
a daemon is present.

Two templates:

* **python** — user directory with ``<ModelName>.py`` (and optional
  ``requirements.txt``); the image starts from a public PyTorch-with-CUDA
  base (``DEFAULT_BASE_IMAGE``, or ``--base-image``) and serves the
  component with ``seldon-tpu-torch-microservice $MODEL_NAME $API_TYPE``
  on the card.
* **cpp** — user directory with a single-binary component (e.g.
  ``component.cpp`` speaking the wire contract, see
  ``examples/cpp-component/``); a builder stage compiles it, the runtime
  stage execs it on the component port.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional

VALID_API_TYPES = ("REST", "GRPC", "BOTH", "FBS")
VALID_SERVICE_TYPES = (
    "MODEL", "ROUTER", "TRANSFORMER", "OUTPUT_TRANSFORMER", "COMBINER",
)
# a public PyTorch image built for CUDA (Docker Hub, pytorch/pytorch)
DEFAULT_BASE_IMAGE = "pytorch/pytorch:2.4.0-cuda12.4-cudnn9-runtime"

PYTHON_DOCKERFILE = """\
# Generated by `sdctl build` (reference parity: wrappers/s2i/python —
# the same MODEL_NAME/API_TYPE/SERVICE_TYPE/PERSISTENCE contract,
# without the s2i toolchain), on PyTorch built for CUDA.
FROM {base_image}

WORKDIR /microservice
# the serving framework; pin/replace with a wheel mirror as needed
RUN pip install --no-cache-dir {framework_spec}
# user component + its dependencies
COPY src/ /microservice/
RUN if [ -f requirements.txt ]; then \\
        pip install --no-cache-dir -r requirements.txt; fi

# SERVICE_TYPE is contract metadata (the graph spec's unit type consumes
# it; the microservice itself derives behavior from the class's methods)
ENV MODEL_NAME={model_name} \\
    API_TYPE={api_type} \\
    SERVICE_TYPE={service_type} \\
    PERSISTENCE={persistence}
EXPOSE 9000 9500
CMD seldon-tpu-torch-microservice $MODEL_NAME $API_TYPE $PERSISTENCE_FLAG
"""

CPP_DOCKERFILE = """\
# Generated by `sdctl build` (C++ component template; the contract the
# binary must speak is documented in examples/cpp-component/).
FROM gcc:13 AS build
WORKDIR /src
COPY src/ /src/
RUN g++ -O2 -std=c++17 -o /component {main_source}

FROM debian:stable-slim
COPY --from=build /component /component
ENV MODEL_NAME={model_name} \\
    API_TYPE={api_type} \\
    SERVICE_TYPE={service_type} \\
    PERSISTENCE={persistence}
EXPOSE 9000
ENTRYPOINT ["/component"]
CMD ["9000"]
"""


def write_build_context(
    src: str,
    out: str,
    model_name: str,
    api_type: str = "REST",
    service_type: str = "MODEL",
    persistence: bool = False,
    language: str = "python",
    base_image: str = DEFAULT_BASE_IMAGE,
    framework_spec: str = "seldon-core-tpu",
    cpp_main: str = "component.cpp",
) -> List[str]:
    """Materialise a docker build context under ``out``; returns the
    files written (relative paths). ``src`` is copied whole into the
    context's ``src/`` so the Dockerfile never reaches outside it."""
    api_type = api_type.upper()
    service_type = service_type.upper()
    if api_type not in VALID_API_TYPES:
        raise ValueError(f"API_TYPE must be one of {VALID_API_TYPES}")
    if service_type not in VALID_SERVICE_TYPES:
        raise ValueError(f"SERVICE_TYPE must be one of {VALID_SERVICE_TYPES}")
    if language == "python":
        entry = os.path.join(src, model_name.split(".")[0] + ".py")
        if not os.path.exists(entry):
            raise FileNotFoundError(
                f"{entry}: MODEL_NAME {model_name!r} needs a matching "
                "module in --src (reference assemble has the same check)"
            )
    elif language == "cpp":
        if not os.path.exists(os.path.join(src, cpp_main)):
            raise FileNotFoundError(f"{os.path.join(src, cpp_main)} missing")
    else:
        raise ValueError("language must be python or cpp")
    src_abs = os.path.abspath(src)
    out_abs = os.path.abspath(out)
    ctx_src_abs = os.path.join(out_abs, "src")
    if out_abs == src_abs or out_abs.startswith(src_abs + os.sep):
        raise ValueError(
            f"--out {out!r} must be outside --src {src!r} (copying the "
            "context into its own source recurses forever)"
        )
    if src_abs == ctx_src_abs or src_abs.startswith(ctx_src_abs + os.sep):
        raise ValueError(
            f"--src {src!r} sits at/under the context's src/ — the "
            "context rebuild would DELETE the user's source; pick a "
            "different --out"
        )
    os.makedirs(out, exist_ok=True)
    ctx_src = os.path.join(out, "src")
    if os.path.exists(ctx_src):
        shutil.rmtree(ctx_src)
    shutil.copytree(src, ctx_src)
    if language == "python":
        content = PYTHON_DOCKERFILE.format(
            base_image=base_image,
            framework_spec=framework_spec,
            model_name=model_name,
            api_type=api_type,
            service_type=service_type,
            persistence=int(persistence),
        )
        # the flag is resolved at container start so one image serves
        # both modes via the PERSISTENCE env var, like the reference's run
        # script
        content = content.replace(
            "$PERSISTENCE_FLAG",
            '$( [ "$PERSISTENCE" = "1" ] && echo --persistence )',
        )
    else:
        content = CPP_DOCKERFILE.format(
            main_source=cpp_main,
            model_name=model_name,
            api_type=api_type,
            service_type=service_type,
            persistence=int(persistence),
        )
    with open(os.path.join(out, "Dockerfile"), "w") as f:
        f.write(content)
    written = ["Dockerfile"]
    for base, _dirs, files in os.walk(ctx_src):
        for name in files:
            written.append(
                os.path.relpath(os.path.join(base, name), out)
            )
    return sorted(written)


def docker_build(out: str, image: str,
                 runner: Optional[callable] = None) -> bool:
    """Run ``docker build -t image out`` when a docker CLI exists;
    returns whether a build ran. ``runner`` is injectable for tests."""
    run = runner or subprocess.run
    if runner is None and shutil.which("docker") is None:
        return False
    run(["docker", "build", "-t", image, out], check=True)
    return True
