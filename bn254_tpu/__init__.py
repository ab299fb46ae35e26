"""bn254_tpu — a JAX-native BN254 pairing and BLS aggregate-signature framework.

A from-scratch JAX/XLA implementation with the full capability surface
of the reference `sedaprotocol/bn254` Rust crate (see SURVEY.md): key
management, BLS sign/verify/aggregate, hash-to-G1, point codecs, NEAR
precompile formatters — plus the batch-first additions the reference lacks:
vmapped batch verification, mesh-sharded multi-chip execution with Fq12
product collectives, and a shared final exponentiation.

Public API (parity with /root/reference/src/lib.rs:60-63):
    PrivateKey, PublicKey, PublicKeyG1, Signature,
    ECDSA, check_public_keys,
    format_pairing_check_values, format_pairing_check_uncompressed_values,
    Bn254Error and subclasses.
"""

from .errors import (
    Bn254Error,
    HashToPointError,
    HexDecodeFailedError,
    IndexOutOfBoundsError,
    InvalidEncodingError,
    InvalidGroupPointError,
    InvalidLengthError,
    NotMemberError,
    PointInJacobianError,
    SerializationError,
    ToAffineConversionError,
    VerificationFailedError,
)
from .protocol.ecdsa import ECDSA, check_public_keys
from .protocol.format import (
    format_pairing_check_uncompressed_values,
    format_pairing_check_values,
)
from .protocol.types import PrivateKey, PublicKey, PublicKeyG1, Signature
from .config import Config

__version__ = "0.2.0"

__all__ = [
    "Config",
    "ECDSA",
    "check_public_keys",
    "PrivateKey",
    "PublicKey",
    "PublicKeyG1",
    "Signature",
    "format_pairing_check_values",
    "format_pairing_check_uncompressed_values",
    "Bn254Error",
    "HashToPointError",
    "IndexOutOfBoundsError",
    "InvalidEncodingError",
    "InvalidGroupPointError",
    "InvalidLengthError",
    "NotMemberError",
    "ToAffineConversionError",
    "PointInJacobianError",
    "VerificationFailedError",
    "SerializationError",
    "HexDecodeFailedError",
    "__version__",
]
