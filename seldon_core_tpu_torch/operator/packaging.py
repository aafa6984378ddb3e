"""Model-image packaging — the s2i/docker-wrapper equivalent; the port's
copy of ``seldon_core_tpu/operator/packaging.py``.

The reference ships source-to-image builders whose contract is four env
vars + a requirements.txt (wrappers/s2i/python/s2i/bin/run:11-21:
``MODEL_NAME``, ``API_TYPE``, ``SERVICE_TYPE``, ``PERSISTENCE``) and a
legacy jinja2 docker wrapper (wrappers/python/wrap_model.py:12-54) that
copies the microservice next to the user model.  Same contract here: point
``package_model`` at a directory containing the user class; it writes a
Dockerfile, a ``.s2i/environment`` file, and a ``run.sh`` that exec's the
port's wrapper CLI (``seldon_core_tpu_torch/runtime/microservice.py``) —
buildable with any container tool, no s2i binary needed.  The base image
is NVIDIA's PyTorch container, which carries CUDA, PyTorch, numpy and the
toolkit's ``nvcc`` but not this package: ``package_model`` stages the
port's sources (its kernels' ``.cu`` files included) into the build
context beside the model, so ``COPY . /microservice`` puts
``seldon_core_tpu_torch`` in the working directory that ``run.sh``'s
``python -m`` imports from.  The port builds its kernels from source at
their first use.
"""

from __future__ import annotations

import os
import shutil
import stat
from dataclasses import dataclass
from typing import Optional

__all__ = ["ImageSpec", "package_model"]

_BASE_IMAGE = "nvcr.io/nvidia/pytorch:24.05-py3"

_DOCKERFILE = """\
FROM {base_image}

WORKDIR /microservice
COPY . /microservice
RUN if [ -f requirements.txt ]; then pip install --no-cache-dir -r requirements.txt; fi

ENV MODEL_NAME={model_name}
ENV API_TYPE={api_type}
ENV SERVICE_TYPE={service_type}
ENV PERSISTENCE={persistence}
EXPOSE 5000

CMD ["/bin/sh", "/microservice/run.sh"]
"""

_RUN_SH = """\
#!/bin/sh
# s2i run contract (reference wrappers/s2i/python/s2i/bin/run:11-21)
exec python -m seldon_core_tpu_torch.runtime.microservice \\
    "$MODEL_NAME" "$API_TYPE" \\
    --service-type "$SERVICE_TYPE" \\
    --persistence "$PERSISTENCE"
"""

_S2I_ENV = """\
MODEL_NAME={model_name}
API_TYPE={api_type}
SERVICE_TYPE={service_type}
PERSISTENCE={persistence}
"""


@dataclass
class ImageSpec:
    model_name: str                 # module:Class or registered unit name
    api_type: str = "REST"          # REST | GRPC
    service_type: str = "MODEL"     # MODEL|ROUTER|TRANSFORMER|COMBINER|OUTLIER_DETECTOR
    persistence: int = 0
    base_image: str = _BASE_IMAGE

    def validate(self) -> None:
        from seldon_core_tpu_torch.runtime.microservice import SERVICE_TYPES

        if self.api_type not in ("REST", "GRPC"):
            raise ValueError(f"api_type must be REST or GRPC, got {self.api_type!r}")
        if self.service_type not in SERVICE_TYPES:
            raise ValueError(f"unknown service_type {self.service_type!r}")
        if not self.model_name:
            raise ValueError("model_name is required")


def package_model(model_dir: str, spec: ImageSpec,
                  out_dir: Optional[str] = None) -> dict:
    """Write Dockerfile / run.sh / .s2i/environment and a copy of the
    ``seldon_core_tpu_torch`` package into ``out_dir`` (default: the model
    dir).  Returns {filename: path} for what was written.
    """
    spec.validate()
    out_dir = out_dir or model_dir
    os.makedirs(out_dir, exist_ok=True)
    if os.path.realpath(out_dir) != os.path.realpath(model_dir):
        # out_dir becomes the docker build context ("COPY . /microservice"),
        # so the model sources must be staged into it
        shutil.copytree(model_dir, out_dir, dirs_exist_ok=True)
    os.makedirs(os.path.join(out_dir, ".s2i"), exist_ok=True)
    fields = dict(
        base_image=spec.base_image,
        model_name=spec.model_name,
        api_type=spec.api_type,
        service_type=spec.service_type,
        persistence=int(spec.persistence),
    )
    written = {}

    def emit(rel: str, content: str, executable: bool = False):
        path = os.path.join(out_dir, rel)
        with open(path, "w") as f:
            f.write(content)
        if executable:
            os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR | stat.S_IXGRP)
        written[rel] = path

    # the port itself, into the context: the base image does not carry it
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    staged = os.path.join(out_dir, os.path.basename(pkg))
    shutil.copytree(pkg, staged, dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc"))
    written[os.path.basename(pkg)] = staged
    emit("Dockerfile", _DOCKERFILE.format(**fields))
    emit("run.sh", _RUN_SH, executable=True)
    emit(os.path.join(".s2i", "environment"), _S2I_ENV.format(**fields))
    return written
