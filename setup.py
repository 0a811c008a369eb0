from setuptools import find_packages, setup

setup(
    name='ninwavelets_tpu',
    version='0.1.0',
    description='TPU-native analytic-wavelet transform engine (JAX/XLA/Pallas)',
    long_description='Frequency-domain wavelet banks (Generalized Morse, '
                     'Morlet/Gabor, Shannon, MexicanHat, Haar) synthesized '
                     'on device; CWT as batched FFT x bank x iFFT; fused '
                     'power/ITC/baseline; multi-chip sharding via pjit.',
    install_requires=['jax', 'numpy'],
    extras_require={
        'plot': ['matplotlib'],
        'mne': ['mne'],
        'test': ['pytest', 'scipy'],
        'torch': ['torch'],
    },
    packages=find_packages(include=['ninwavelets_tpu', 'ninwavelets_tpu.*',
                                    'ninwavelets_tpu_torch',
                                    'ninwavelets_tpu_torch.*']),
    package_data={'ninwavelets_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh',
                                            'io/_native/io.cpp']},
    python_requires='>=3.10',
)
