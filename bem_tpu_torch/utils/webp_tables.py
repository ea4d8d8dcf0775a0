"""The constant tables of the VP8 (lossy WebP) bitstream, RFC 6386:

- ``COEFF_PROBA0``: the default token probabilities, [type 4][band 8][context 3]
  [node 11] (RFC 6386 section 13.5, ``default_coeff_probs``);
- ``COEFF_UPDATE_PROBA``: the probability that a frame header updates each
  of them (section 13.4, ``coeff_update_probs``);
- ``BMODES_PROBA``: the key frame's 4x4 intra-mode probabilities given the
  modes above and to the left, [top 10][left 10][node 9] (section 11.5,
  ``kf_bmode_probs``), its modes in the order DC, TM, VE, HE, RD, VR, LD,
  VL, HD, HU;
- ``DC_TABLE`` / ``AC_TABLE``: the quantizer step of each index 0-127
  (section 14.1, ``dc_qlookup`` / ``ac_qlookup``);
- ``CODE_TO_PLANE``: the lossless format's 120 short distance codes, each
  (dy << 4) | (8 - dx) (WebP lossless bitstream, section 4.2.2).
"""

from __future__ import annotations

import numpy as np


def _table(rows, shape):
    return np.frombuffer(bytes.fromhex("".join(rows)), np.uint8).reshape(shape)


COEFF_PROBA0 = _table((
    "808080808080808080808080808080808080808080808080808080808080808080"
    "fd88feffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff808080"
    "0162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb808080"
    "01b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece68080808080"
    "0165fbfff1ff8080808080aa8bf1fcecd1ffff8080802574c4f3e4ffffff808080"
    "01ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3ab8080808080"
    "0198fcfff0ff8080808080b187f3ffeae180808080805081d3ffc2e08080808080"
    "0101ff8080808080808080f601ff8080808080808080ff80808080808080808080"
    "c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f92d095a7dda2ffdf80"
    "0195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0bef9caffff80"
    "0181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2ffff80"
    "01c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc7808080"
    "01b6f9ffe8eb80808080807c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080"
    "019df7ffece7ffff808080798debffe1e3ffff8080802d63bcfbc3d9ffe0808080"
    "0101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80"
    "015ff7fdd4b7ffff808080ef5af4fad3d1ffff8080809b4dc3f8bcc3ffff808080"
    "0118effbdadbffcd808080c933dbffc4ba8080808080452ebeefc9daffe4808080"
    "01bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff808080808080"
    "0110f8ffff808080808080be24e6ffecff80808080809501ff8080808080808080"
    "01e2ff8080808080808080f7c0ff8080808080808080f080ff8080808080808080"
    "0186fcffff808080808080d53efaffff808080808080375dff8080808080808080"
    "808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd880"
    "0170e6fac7bff79fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff80"
    "0134dcf6c6c7f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff80"
    "01b6e1f9dbf0ffe08080809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff80"
    "0151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb808080"
    "01def8ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff808080"
    "0179ecfdd4d6ffff8080808d54d5fcc9caffdb8080802a50a0f0a2b9ffcd808080"
    "0101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080"
), (4, 8, 3, 11))

COEFF_UPDATE_PROBA = _table((
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "b0f6ffffffffffffffffffdff1fcfffffffffffffffff9fdfdffffffffffffffff"
    "fff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffffffffff"
    "fff6feffffffffffffffffeffdfefffffffffffffffffefffeffffffffffffffff"
    "fff8fefffffffffffffffffbfffeffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffbfefefffffffffffffffffefffeffffffffffffffff"
    "fffefdfffefffffffffffffafffefffefffffffffffffeffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "d9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafaf1fafdfffdfeffffff"
    "fffeffffffffffffffffffdffefeffffffffffffffffeefdfefeffffffffffffff"
    "fff8fefffffffffffffffff9feffffffffffffffffffffffffffffffffffffffff"
    "fffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcffffffffffffffffffffffffffffffffffffffffff"
    "fffefefffffffffffffffffdffffffffffffffffffffffffffffffffffffffffff"
    "fffefdfffffffffffffffffafffffffffffffffffffffeffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffeffffffff"
    "fffdfeffffffffffffffffecfdfefffffffffffffffffbfdfdfefeffffffffffff"
    "fffefefffffffffffffffffefefeffffffffffffffffffffffffffffffffffffff"
    "fffefffffffffffffffffffefefffffffffffffffffffeffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdffffffffffffff"
    "fffdfdfffffffffffffffff6fdfdfffffffffffffffffcfefbfefeffffffffffff"
    "fffefcfffffffffffffffff8fefdfffffffffffffffffdfffefeffffffffffffff"
    "fffbfefffffffffffffffff5fbfefffffffffffffffffdfdfeffffffffffffffff"
    "fffbfdfffffffffffffffffcfdfefffffffffffffffffffeffffffffffffffffff"
    "fffcfffffffffffffffffff9fffefffffffffffffffffffffeffffffffffffffff"
    "fffffdfffffffffffffffffaffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff"
), (4, 8, 3, 11))

BMODES_PROBA = _table((
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150aad"
    "791850c31a3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d1024"
    "86b7598962656aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d"
    "412669a033341f7380684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5bd171216"
    "585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab3aa55a6240"
    "221674ce17222ba6496b36201a3301512b1f44196a1640ab24e1722213156684bc104c7c3e124e5f5539323033"
    "c165239fd76f592e6f3c941facdbe415126f70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a"
    "3d3f1e9b432d4401d16450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd333211a8d1c0171952"
    "8a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af2f0f10b722df312db7"
    "2e1121b706620f20b7392e16188001361125412049731c801780cd2803097333c01206df572509733b4d40152f"
    "68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a8598740a2086271335dd1a722049ff"
    "1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd2d25c03726467c4966012262"
    "7d622a58685575af525f543559806471652d4b4f7b2f338051ab0139110547663935293126210d7939491a0155"
    "290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a6666d522142b75140f24a38044011a"
    "663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113469255373e46252b259a64a355a001"
    "3f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808118489ff3774803a0f145287391a7928"
    "a4321f899a851923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d12d10155b40de0701c5"
    "3815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab120b073f90ab0404f6231b0a92aeab0c1a80"
    "be502363b4507e362d557e2f57b033291420654b808b769274805538290fb0ec5525093e471e117776ff11128a"
    "65263c8a37462b1a8e9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc380300418"
), (10, 10, 9))

DC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21,
    22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38,
    39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78,
    79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104,
    106, 108, 110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140,
    143, 145, 148, 151, 154, 157)

AC_TABLE = (
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
    26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46,
    47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114,
    116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164,
    167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229,
    234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284)

CODE_TO_PLANE = (
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58, 37, 43,
    72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3, 87, 89, 19,
    29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30, 102, 106, 34,
    46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31, 100, 108,
    66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65, 79,
    16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112)
