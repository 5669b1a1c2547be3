// The dynamic shared memory one block of a wide IPA kernel
// (ipa_attention_wide_fwd.cu, ipa_attention_wide_bwd.cu) may use: 227 KB,
// sm_90's opt-in maximum per block. Both launchers refuse widths whose
// tiles need more, and the wrappers read the same figure through
// ipa_attention_wide_smem_limit to route such widths to a ValueError.
#pragma once

#include <stddef.h>

namespace ipa_wide {
constexpr size_t kMaxSmem = 232448;
}  // namespace ipa_wide
