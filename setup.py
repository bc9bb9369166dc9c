from setuptools import find_packages, setup

setup(
    name="sharkmer-tpu",
    version="0.1.0",
    description="TPU-native k-mer counting and in silico PCR",
    packages=find_packages(exclude=("tests",)),
    package_data={
        "sharkmer_tpu": ["panels/*.yaml", "panels/README.md"],
        "sharkmer_tpu_torch": ["panels/*.yaml", "panels/README.md",
                               "csrc/*.cu"],
    },
    entry_points={"console_scripts": ["sharkmer=sharkmer_tpu.main:main",
        "sharkmer-viewer=sharkmer_tpu.viewer:main",
        "sharkmer-torch=sharkmer_tpu_torch.main:main",
        "sharkmer-torch-viewer=sharkmer_tpu_torch.viewer:main"]},
    python_requires=">=3.10",
)
