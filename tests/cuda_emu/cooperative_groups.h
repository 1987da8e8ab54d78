// Cooperative groups for the CPU stand-in: see cuda_runtime.h.
#pragma once
#include "cuda_runtime.h"
