"""Process exit codes — the analog of the reference's ``ReturnCode`` enum
(its ``inc/enums.h:4-11``: Success / OpenCLDeviceError /
OpenCLProgramError / FileError / OtherError).

A copy of ``spmv_tpu/errors.py``: importing that module pulls in the JAX
package (``spmv_tpu/__init__.py`` imports every container), and the port
must run where JAX is not installed."""

from __future__ import annotations

import enum


class ReturnCode(enum.IntEnum):
    SUCCESS = 0
    DEVICE_ERROR = 1      # no usable accelerator / runtime failure
    PROGRAM_ERROR = 2     # kernel compilation failure
    FILE_ERROR = 3        # missing or malformed matrix file
    OTHER_ERROR = 4
    VALIDATION_FAILED = 5  # new: kernel output failed the golden check
