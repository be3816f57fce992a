from setuptools import find_packages, setup

setup(
    name="miniprot_tpu",
    version="0.1.0",
    description="TPU-native protein-to-genome aligner (miniprot capability)",
    packages=find_packages(exclude=("tests",)),
    package_data={"miniprot_tpu.native": ["*.c"],
                  "miniprot_tpu_torch.native": ["*.c"],
                  "miniprot_tpu_torch.kernels": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["numpy"],
    extras_require={"tpu": ["jax"], "gpu": ["torch"]},
    entry_points={"console_scripts": [
        "miniprot-tpu=miniprot_tpu.cli:main",
        "miniprot-tpu-torch=miniprot_tpu_torch.cli:main"]},
)
