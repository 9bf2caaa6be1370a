// Generated by distributed_point_functions_tpu_torch/ops/sbox_codegen.py; do not edit.
// Plane p = 8 * byte + bit of the AES state; one uint32_t word holds that bit for 32 lanes.
#pragma once
#include <cstdint>

// Tower-field S-box on the 8 bit planes of one state byte, in place
// (116 XOR, 48 AND, 4 NOT).
__device__ __forceinline__ void sbox_tower(uint32_t& b0, uint32_t& b1, uint32_t& b2, uint32_t& b3, uint32_t& b4, uint32_t& b5, uint32_t& b6, uint32_t& b7) {
  const uint32_t x0 = b0;
  const uint32_t x1 = b1;
  const uint32_t x2 = b2;
  const uint32_t x3 = b3;
  const uint32_t x4 = b4;
  const uint32_t x5 = b5;
  const uint32_t x6 = b6;
  const uint32_t x7 = b7;
  const uint32_t t0 = x0 ^ x1;
  const uint32_t t1 = x2 ^ x4;
  const uint32_t t2 = t1 ^ x5;
  const uint32_t t3 = x2 ^ x3;
  const uint32_t t4 = t3 ^ x4;
  const uint32_t t5 = t4 ^ x7;
  const uint32_t t6 = x3 ^ x5;
  const uint32_t t7 = t6 ^ x6;
  const uint32_t t8 = x4 ^ x5;
  const uint32_t t9 = t8 ^ x6;
  const uint32_t t10 = x1 ^ x2;
  const uint32_t t11 = t10 ^ x3;
  const uint32_t t12 = t11 ^ x4;
  const uint32_t t13 = t12 ^ x6;
  const uint32_t t14 = t13 ^ x7;
  const uint32_t t15 = x5 ^ x7;
  const uint32_t t16 = t0 ^ t9;
  const uint32_t t17 = t2 ^ t3;
  const uint32_t t18 = t14 ^ t5;
  const uint32_t t19 = t15 ^ t7;
  const uint32_t t20 = t14 ^ t15;
  const uint32_t t21 = t14 ^ t3;
  const uint32_t t22 = t15 ^ t21;
  const uint32_t t23 = t15 ^ t9;
  const uint32_t t24 = t19 & t7;
  const uint32_t t25 = t18 & t5;
  const uint32_t t26 = t24 ^ t25;
  const uint32_t t27 = t18 & t7;
  const uint32_t t28 = t24 ^ t27;
  const uint32_t t29 = t19 & t5;
  const uint32_t t30 = t28 ^ t29;
  const uint32_t t31 = t17 & t2;
  const uint32_t t32 = t0 & t16;
  const uint32_t t33 = t31 ^ t32;
  const uint32_t t34 = t16 & t2;
  const uint32_t t35 = t31 ^ t34;
  const uint32_t t36 = t0 & t17;
  const uint32_t t37 = t35 ^ t36;
  const uint32_t t38 = t0 ^ t5;
  const uint32_t t39 = t2 ^ t7;
  const uint32_t t40 = t16 ^ t18;
  const uint32_t t41 = t17 ^ t19;
  const uint32_t t42 = t39 & t41;
  const uint32_t t43 = t38 & t40;
  const uint32_t t44 = t42 ^ t43;
  const uint32_t t45 = t39 & t40;
  const uint32_t t46 = t42 ^ t45;
  const uint32_t t47 = t38 & t41;
  const uint32_t t48 = t46 ^ t47;
  const uint32_t t49 = t26 ^ t30;
  const uint32_t t50 = t30 ^ t33;
  const uint32_t t51 = t37 ^ t49;
  const uint32_t t52 = t33 ^ t44;
  const uint32_t t53 = t37 ^ t48;
  const uint32_t t54 = t14 ^ t50;
  const uint32_t t55 = t20 ^ t51;
  const uint32_t t56 = t22 ^ t52;
  const uint32_t t57 = t23 ^ t53;
  const uint32_t t58 = t54 ^ t56;
  const uint32_t t59 = t55 ^ t57;
  const uint32_t t60 = t56 ^ t57;
  const uint32_t t61 = t57 ^ t60;
  const uint32_t t62 = t55 & t59;
  const uint32_t t63 = t54 & t58;
  const uint32_t t64 = t62 ^ t63;
  const uint32_t t65 = t55 & t58;
  const uint32_t t66 = t62 ^ t65;
  const uint32_t t67 = t54 & t59;
  const uint32_t t68 = t66 ^ t67;
  const uint32_t t69 = t57 ^ t64;
  const uint32_t t70 = t61 ^ t68;
  const uint32_t t71 = t69 ^ t70;
  const uint32_t t72 = t59 & t70;
  const uint32_t t73 = t58 & t71;
  const uint32_t t74 = t72 ^ t73;
  const uint32_t t75 = t59 & t71;
  const uint32_t t76 = t72 ^ t75;
  const uint32_t t77 = t58 & t70;
  const uint32_t t78 = t76 ^ t77;
  const uint32_t t79 = t57 & t70;
  const uint32_t t80 = t56 & t71;
  const uint32_t t81 = t79 ^ t80;
  const uint32_t t82 = t57 & t71;
  const uint32_t t83 = t79 ^ t82;
  const uint32_t t84 = t56 & t70;
  const uint32_t t85 = t83 ^ t84;
  const uint32_t t86 = t19 & t85;
  const uint32_t t87 = t18 & t81;
  const uint32_t t88 = t86 ^ t87;
  const uint32_t t89 = t19 & t81;
  const uint32_t t90 = t86 ^ t89;
  const uint32_t t91 = t18 & t85;
  const uint32_t t92 = t90 ^ t91;
  const uint32_t t93 = t17 & t78;
  const uint32_t t94 = t16 & t74;
  const uint32_t t95 = t93 ^ t94;
  const uint32_t t96 = t17 & t74;
  const uint32_t t97 = t93 ^ t96;
  const uint32_t t98 = t16 & t78;
  const uint32_t t99 = t97 ^ t98;
  const uint32_t t100 = t74 ^ t81;
  const uint32_t t101 = t78 ^ t85;
  const uint32_t t102 = t101 & t41;
  const uint32_t t103 = t100 & t40;
  const uint32_t t104 = t102 ^ t103;
  const uint32_t t105 = t100 & t41;
  const uint32_t t106 = t102 ^ t105;
  const uint32_t t107 = t101 & t40;
  const uint32_t t108 = t106 ^ t107;
  const uint32_t t109 = t88 ^ t92;
  const uint32_t t110 = t92 ^ t95;
  const uint32_t t111 = t109 ^ t99;
  const uint32_t t112 = t104 ^ t95;
  const uint32_t t113 = t108 ^ t99;
  const uint32_t t114 = t15 & t85;
  const uint32_t t115 = t14 & t81;
  const uint32_t t116 = t114 ^ t115;
  const uint32_t t117 = t15 & t81;
  const uint32_t t118 = t114 ^ t117;
  const uint32_t t119 = t14 & t85;
  const uint32_t t120 = t118 ^ t119;
  const uint32_t t121 = t3 & t78;
  const uint32_t t122 = t74 & t9;
  const uint32_t t123 = t121 ^ t122;
  const uint32_t t124 = t3 & t74;
  const uint32_t t125 = t121 ^ t124;
  const uint32_t t126 = t78 & t9;
  const uint32_t t127 = t125 ^ t126;
  const uint32_t t128 = t14 ^ t9;
  const uint32_t t129 = t15 ^ t3;
  const uint32_t t130 = t101 & t129;
  const uint32_t t131 = t100 & t128;
  const uint32_t t132 = t130 ^ t131;
  const uint32_t t133 = t100 & t129;
  const uint32_t t134 = t130 ^ t133;
  const uint32_t t135 = t101 & t128;
  const uint32_t t136 = t134 ^ t135;
  const uint32_t t137 = t116 ^ t120;
  const uint32_t t138 = t120 ^ t123;
  const uint32_t t139 = t127 ^ t137;
  const uint32_t t140 = t123 ^ t132;
  const uint32_t t141 = t127 ^ t136;
  const uint32_t t142 = t110 ^ t111;
  const uint32_t t143 = t113 ^ t142;
  const uint32_t t144 = t138 ^ t143;
  const uint32_t t145 = t140 ^ t144;
  const uint32_t t146 = t110 ^ t112;
  const uint32_t t147 = t138 ^ t146;
  const uint32_t t148 = t139 ^ t147;
  const uint32_t t149 = t110 ^ t113;
  const uint32_t t150 = t139 ^ t149;
  const uint32_t t151 = t141 ^ t150;
  const uint32_t t152 = t141 ^ t144;
  const uint32_t t153 = t112 ^ t142;
  const uint32_t t154 = t113 ^ t153;
  const uint32_t t155 = t138 ^ t154;
  const uint32_t t156 = t139 ^ t155;
  const uint32_t t157 = t141 ^ t156;
  const uint32_t t158 = t112 ^ t138;
  const uint32_t t159 = t139 ^ t158;
  const uint32_t t160 = t140 ^ t159;
  const uint32_t t161 = t138 ^ t139;
  const uint32_t t162 = t112 ^ t113;
  const uint32_t t163 = t139 ^ t162;
  const uint32_t t164 = ~t145;
  const uint32_t t165 = ~t148;
  const uint32_t t166 = ~t160;
  const uint32_t t167 = ~t161;
  b0 = t164;
  b1 = t165;
  b2 = t151;
  b3 = t152;
  b4 = t157;
  b5 = t166;
  b6 = t167;
  b7 = t163;
}

// SubBytes: the S-box on each of the 16 state bytes.
__device__ __forceinline__ void sub_bytes(uint32_t (&s)[128]) {
  sbox_tower(s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]);
  sbox_tower(s[8], s[9], s[10], s[11], s[12], s[13], s[14], s[15]);
  sbox_tower(s[16], s[17], s[18], s[19], s[20], s[21], s[22], s[23]);
  sbox_tower(s[24], s[25], s[26], s[27], s[28], s[29], s[30], s[31]);
  sbox_tower(s[32], s[33], s[34], s[35], s[36], s[37], s[38], s[39]);
  sbox_tower(s[40], s[41], s[42], s[43], s[44], s[45], s[46], s[47]);
  sbox_tower(s[48], s[49], s[50], s[51], s[52], s[53], s[54], s[55]);
  sbox_tower(s[56], s[57], s[58], s[59], s[60], s[61], s[62], s[63]);
  sbox_tower(s[64], s[65], s[66], s[67], s[68], s[69], s[70], s[71]);
  sbox_tower(s[72], s[73], s[74], s[75], s[76], s[77], s[78], s[79]);
  sbox_tower(s[80], s[81], s[82], s[83], s[84], s[85], s[86], s[87]);
  sbox_tower(s[88], s[89], s[90], s[91], s[92], s[93], s[94], s[95]);
  sbox_tower(s[96], s[97], s[98], s[99], s[100], s[101], s[102], s[103]);
  sbox_tower(s[104], s[105], s[106], s[107], s[108], s[109], s[110], s[111]);
  sbox_tower(s[112], s[113], s[114], s[115], s[116], s[117], s[118], s[119]);
  sbox_tower(s[120], s[121], s[122], s[123], s[124], s[125], s[126], s[127]);
}

// ShiftRows alone (the last round): byte k takes byte SR[k].
__device__ __forceinline__ void shift_rows(uint32_t (&s)[128]) {
  const uint32_t r40 = s[40];
  const uint32_t r41 = s[41];
  const uint32_t r42 = s[42];
  const uint32_t r43 = s[43];
  const uint32_t r44 = s[44];
  const uint32_t r45 = s[45];
  const uint32_t r46 = s[46];
  const uint32_t r47 = s[47];
  const uint32_t r80 = s[80];
  const uint32_t r81 = s[81];
  const uint32_t r82 = s[82];
  const uint32_t r83 = s[83];
  const uint32_t r84 = s[84];
  const uint32_t r85 = s[85];
  const uint32_t r86 = s[86];
  const uint32_t r87 = s[87];
  const uint32_t r120 = s[120];
  const uint32_t r121 = s[121];
  const uint32_t r122 = s[122];
  const uint32_t r123 = s[123];
  const uint32_t r124 = s[124];
  const uint32_t r125 = s[125];
  const uint32_t r126 = s[126];
  const uint32_t r127 = s[127];
  const uint32_t r72 = s[72];
  const uint32_t r73 = s[73];
  const uint32_t r74 = s[74];
  const uint32_t r75 = s[75];
  const uint32_t r76 = s[76];
  const uint32_t r77 = s[77];
  const uint32_t r78 = s[78];
  const uint32_t r79 = s[79];
  const uint32_t r112 = s[112];
  const uint32_t r113 = s[113];
  const uint32_t r114 = s[114];
  const uint32_t r115 = s[115];
  const uint32_t r116 = s[116];
  const uint32_t r117 = s[117];
  const uint32_t r118 = s[118];
  const uint32_t r119 = s[119];
  const uint32_t r24 = s[24];
  const uint32_t r25 = s[25];
  const uint32_t r26 = s[26];
  const uint32_t r27 = s[27];
  const uint32_t r28 = s[28];
  const uint32_t r29 = s[29];
  const uint32_t r30 = s[30];
  const uint32_t r31 = s[31];
  const uint32_t r104 = s[104];
  const uint32_t r105 = s[105];
  const uint32_t r106 = s[106];
  const uint32_t r107 = s[107];
  const uint32_t r108 = s[108];
  const uint32_t r109 = s[109];
  const uint32_t r110 = s[110];
  const uint32_t r111 = s[111];
  const uint32_t r16 = s[16];
  const uint32_t r17 = s[17];
  const uint32_t r18 = s[18];
  const uint32_t r19 = s[19];
  const uint32_t r20 = s[20];
  const uint32_t r21 = s[21];
  const uint32_t r22 = s[22];
  const uint32_t r23 = s[23];
  const uint32_t r56 = s[56];
  const uint32_t r57 = s[57];
  const uint32_t r58 = s[58];
  const uint32_t r59 = s[59];
  const uint32_t r60 = s[60];
  const uint32_t r61 = s[61];
  const uint32_t r62 = s[62];
  const uint32_t r63 = s[63];
  const uint32_t r8 = s[8];
  const uint32_t r9 = s[9];
  const uint32_t r10 = s[10];
  const uint32_t r11 = s[11];
  const uint32_t r12 = s[12];
  const uint32_t r13 = s[13];
  const uint32_t r14 = s[14];
  const uint32_t r15 = s[15];
  const uint32_t r48 = s[48];
  const uint32_t r49 = s[49];
  const uint32_t r50 = s[50];
  const uint32_t r51 = s[51];
  const uint32_t r52 = s[52];
  const uint32_t r53 = s[53];
  const uint32_t r54 = s[54];
  const uint32_t r55 = s[55];
  const uint32_t r88 = s[88];
  const uint32_t r89 = s[89];
  const uint32_t r90 = s[90];
  const uint32_t r91 = s[91];
  const uint32_t r92 = s[92];
  const uint32_t r93 = s[93];
  const uint32_t r94 = s[94];
  const uint32_t r95 = s[95];
  s[8] = r40;
  s[9] = r41;
  s[10] = r42;
  s[11] = r43;
  s[12] = r44;
  s[13] = r45;
  s[14] = r46;
  s[15] = r47;
  s[16] = r80;
  s[17] = r81;
  s[18] = r82;
  s[19] = r83;
  s[20] = r84;
  s[21] = r85;
  s[22] = r86;
  s[23] = r87;
  s[24] = r120;
  s[25] = r121;
  s[26] = r122;
  s[27] = r123;
  s[28] = r124;
  s[29] = r125;
  s[30] = r126;
  s[31] = r127;
  s[40] = r72;
  s[41] = r73;
  s[42] = r74;
  s[43] = r75;
  s[44] = r76;
  s[45] = r77;
  s[46] = r78;
  s[47] = r79;
  s[48] = r112;
  s[49] = r113;
  s[50] = r114;
  s[51] = r115;
  s[52] = r116;
  s[53] = r117;
  s[54] = r118;
  s[55] = r119;
  s[56] = r24;
  s[57] = r25;
  s[58] = r26;
  s[59] = r27;
  s[60] = r28;
  s[61] = r29;
  s[62] = r30;
  s[63] = r31;
  s[72] = r104;
  s[73] = r105;
  s[74] = r106;
  s[75] = r107;
  s[76] = r108;
  s[77] = r109;
  s[78] = r110;
  s[79] = r111;
  s[80] = r16;
  s[81] = r17;
  s[82] = r18;
  s[83] = r19;
  s[84] = r20;
  s[85] = r21;
  s[86] = r22;
  s[87] = r23;
  s[88] = r56;
  s[89] = r57;
  s[90] = r58;
  s[91] = r59;
  s[92] = r60;
  s[93] = r61;
  s[94] = r62;
  s[95] = r63;
  s[104] = r8;
  s[105] = r9;
  s[106] = r10;
  s[107] = r11;
  s[108] = r12;
  s[109] = r13;
  s[110] = r14;
  s[111] = r15;
  s[112] = r48;
  s[113] = r49;
  s[114] = r50;
  s[115] = r51;
  s[116] = r52;
  s[117] = r53;
  s[118] = r54;
  s[119] = r55;
  s[120] = r88;
  s[121] = r89;
  s[122] = r90;
  s[123] = r91;
  s[124] = r92;
  s[125] = r93;
  s[126] = r94;
  s[127] = r95;
}

// ShiftRows then MixColumns (rounds 1-9): per column c,
// o_r = a_r ^ t ^ xtime(a_r ^ a_{r+1}) with t = a_0 ^ a_1 ^ a_2 ^ a_3.
__device__ __forceinline__ void shift_rows_mix_columns(uint32_t (&s)[128]) {
  const uint32_t r0 = s[0];
  const uint32_t r1 = s[1];
  const uint32_t r2 = s[2];
  const uint32_t r3 = s[3];
  const uint32_t r4 = s[4];
  const uint32_t r5 = s[5];
  const uint32_t r6 = s[6];
  const uint32_t r7 = s[7];
  const uint32_t r8 = s[8];
  const uint32_t r9 = s[9];
  const uint32_t r10 = s[10];
  const uint32_t r11 = s[11];
  const uint32_t r12 = s[12];
  const uint32_t r13 = s[13];
  const uint32_t r14 = s[14];
  const uint32_t r15 = s[15];
  const uint32_t r16 = s[16];
  const uint32_t r17 = s[17];
  const uint32_t r18 = s[18];
  const uint32_t r19 = s[19];
  const uint32_t r20 = s[20];
  const uint32_t r21 = s[21];
  const uint32_t r22 = s[22];
  const uint32_t r23 = s[23];
  const uint32_t r24 = s[24];
  const uint32_t r25 = s[25];
  const uint32_t r26 = s[26];
  const uint32_t r27 = s[27];
  const uint32_t r28 = s[28];
  const uint32_t r29 = s[29];
  const uint32_t r30 = s[30];
  const uint32_t r31 = s[31];
  const uint32_t r32 = s[32];
  const uint32_t r33 = s[33];
  const uint32_t r34 = s[34];
  const uint32_t r35 = s[35];
  const uint32_t r36 = s[36];
  const uint32_t r37 = s[37];
  const uint32_t r38 = s[38];
  const uint32_t r39 = s[39];
  const uint32_t r40 = s[40];
  const uint32_t r41 = s[41];
  const uint32_t r42 = s[42];
  const uint32_t r43 = s[43];
  const uint32_t r44 = s[44];
  const uint32_t r45 = s[45];
  const uint32_t r46 = s[46];
  const uint32_t r47 = s[47];
  const uint32_t r48 = s[48];
  const uint32_t r49 = s[49];
  const uint32_t r50 = s[50];
  const uint32_t r51 = s[51];
  const uint32_t r52 = s[52];
  const uint32_t r53 = s[53];
  const uint32_t r54 = s[54];
  const uint32_t r55 = s[55];
  const uint32_t r56 = s[56];
  const uint32_t r57 = s[57];
  const uint32_t r58 = s[58];
  const uint32_t r59 = s[59];
  const uint32_t r60 = s[60];
  const uint32_t r61 = s[61];
  const uint32_t r62 = s[62];
  const uint32_t r63 = s[63];
  const uint32_t r64 = s[64];
  const uint32_t r65 = s[65];
  const uint32_t r66 = s[66];
  const uint32_t r67 = s[67];
  const uint32_t r68 = s[68];
  const uint32_t r69 = s[69];
  const uint32_t r70 = s[70];
  const uint32_t r71 = s[71];
  const uint32_t r72 = s[72];
  const uint32_t r73 = s[73];
  const uint32_t r74 = s[74];
  const uint32_t r75 = s[75];
  const uint32_t r76 = s[76];
  const uint32_t r77 = s[77];
  const uint32_t r78 = s[78];
  const uint32_t r79 = s[79];
  const uint32_t r80 = s[80];
  const uint32_t r81 = s[81];
  const uint32_t r82 = s[82];
  const uint32_t r83 = s[83];
  const uint32_t r84 = s[84];
  const uint32_t r85 = s[85];
  const uint32_t r86 = s[86];
  const uint32_t r87 = s[87];
  const uint32_t r88 = s[88];
  const uint32_t r89 = s[89];
  const uint32_t r90 = s[90];
  const uint32_t r91 = s[91];
  const uint32_t r92 = s[92];
  const uint32_t r93 = s[93];
  const uint32_t r94 = s[94];
  const uint32_t r95 = s[95];
  const uint32_t r96 = s[96];
  const uint32_t r97 = s[97];
  const uint32_t r98 = s[98];
  const uint32_t r99 = s[99];
  const uint32_t r100 = s[100];
  const uint32_t r101 = s[101];
  const uint32_t r102 = s[102];
  const uint32_t r103 = s[103];
  const uint32_t r104 = s[104];
  const uint32_t r105 = s[105];
  const uint32_t r106 = s[106];
  const uint32_t r107 = s[107];
  const uint32_t r108 = s[108];
  const uint32_t r109 = s[109];
  const uint32_t r110 = s[110];
  const uint32_t r111 = s[111];
  const uint32_t r112 = s[112];
  const uint32_t r113 = s[113];
  const uint32_t r114 = s[114];
  const uint32_t r115 = s[115];
  const uint32_t r116 = s[116];
  const uint32_t r117 = s[117];
  const uint32_t r118 = s[118];
  const uint32_t r119 = s[119];
  const uint32_t r120 = s[120];
  const uint32_t r121 = s[121];
  const uint32_t r122 = s[122];
  const uint32_t r123 = s[123];
  const uint32_t r124 = s[124];
  const uint32_t r125 = s[125];
  const uint32_t r126 = s[126];
  const uint32_t r127 = s[127];
  {
    const uint32_t t0 = r0 ^ r40 ^ r80 ^ r120;
    const uint32_t t1 = r1 ^ r41 ^ r81 ^ r121;
    const uint32_t t2 = r2 ^ r42 ^ r82 ^ r122;
    const uint32_t t3 = r3 ^ r43 ^ r83 ^ r123;
    const uint32_t t4 = r4 ^ r44 ^ r84 ^ r124;
    const uint32_t t5 = r5 ^ r45 ^ r85 ^ r125;
    const uint32_t t6 = r6 ^ r46 ^ r86 ^ r126;
    const uint32_t t7 = r7 ^ r47 ^ r87 ^ r127;
    const uint32_t u0_0 = r0 ^ r40;
    const uint32_t u0_1 = r1 ^ r41;
    const uint32_t u0_2 = r2 ^ r42;
    const uint32_t u0_3 = r3 ^ r43;
    const uint32_t u0_4 = r4 ^ r44;
    const uint32_t u0_5 = r5 ^ r45;
    const uint32_t u0_6 = r6 ^ r46;
    const uint32_t u0_7 = r7 ^ r47;
    const uint32_t u1_0 = r40 ^ r80;
    const uint32_t u1_1 = r41 ^ r81;
    const uint32_t u1_2 = r42 ^ r82;
    const uint32_t u1_3 = r43 ^ r83;
    const uint32_t u1_4 = r44 ^ r84;
    const uint32_t u1_5 = r45 ^ r85;
    const uint32_t u1_6 = r46 ^ r86;
    const uint32_t u1_7 = r47 ^ r87;
    const uint32_t u2_0 = r80 ^ r120;
    const uint32_t u2_1 = r81 ^ r121;
    const uint32_t u2_2 = r82 ^ r122;
    const uint32_t u2_3 = r83 ^ r123;
    const uint32_t u2_4 = r84 ^ r124;
    const uint32_t u2_5 = r85 ^ r125;
    const uint32_t u2_6 = r86 ^ r126;
    const uint32_t u2_7 = r87 ^ r127;
    const uint32_t u3_0 = r120 ^ r0;
    const uint32_t u3_1 = r121 ^ r1;
    const uint32_t u3_2 = r122 ^ r2;
    const uint32_t u3_3 = r123 ^ r3;
    const uint32_t u3_4 = r124 ^ r4;
    const uint32_t u3_5 = r125 ^ r5;
    const uint32_t u3_6 = r126 ^ r6;
    const uint32_t u3_7 = r127 ^ r7;
    s[0] = r0 ^ t0 ^ u0_7;
    s[1] = r1 ^ t1 ^ u0_0 ^ u0_7;
    s[2] = r2 ^ t2 ^ u0_1;
    s[3] = r3 ^ t3 ^ u0_2 ^ u0_7;
    s[4] = r4 ^ t4 ^ u0_3 ^ u0_7;
    s[5] = r5 ^ t5 ^ u0_4;
    s[6] = r6 ^ t6 ^ u0_5;
    s[7] = r7 ^ t7 ^ u0_6;
    s[8] = r40 ^ t0 ^ u1_7;
    s[9] = r41 ^ t1 ^ u1_0 ^ u1_7;
    s[10] = r42 ^ t2 ^ u1_1;
    s[11] = r43 ^ t3 ^ u1_2 ^ u1_7;
    s[12] = r44 ^ t4 ^ u1_3 ^ u1_7;
    s[13] = r45 ^ t5 ^ u1_4;
    s[14] = r46 ^ t6 ^ u1_5;
    s[15] = r47 ^ t7 ^ u1_6;
    s[16] = r80 ^ t0 ^ u2_7;
    s[17] = r81 ^ t1 ^ u2_0 ^ u2_7;
    s[18] = r82 ^ t2 ^ u2_1;
    s[19] = r83 ^ t3 ^ u2_2 ^ u2_7;
    s[20] = r84 ^ t4 ^ u2_3 ^ u2_7;
    s[21] = r85 ^ t5 ^ u2_4;
    s[22] = r86 ^ t6 ^ u2_5;
    s[23] = r87 ^ t7 ^ u2_6;
    s[24] = r120 ^ t0 ^ u3_7;
    s[25] = r121 ^ t1 ^ u3_0 ^ u3_7;
    s[26] = r122 ^ t2 ^ u3_1;
    s[27] = r123 ^ t3 ^ u3_2 ^ u3_7;
    s[28] = r124 ^ t4 ^ u3_3 ^ u3_7;
    s[29] = r125 ^ t5 ^ u3_4;
    s[30] = r126 ^ t6 ^ u3_5;
    s[31] = r127 ^ t7 ^ u3_6;
  }
  {
    const uint32_t t0 = r32 ^ r72 ^ r112 ^ r24;
    const uint32_t t1 = r33 ^ r73 ^ r113 ^ r25;
    const uint32_t t2 = r34 ^ r74 ^ r114 ^ r26;
    const uint32_t t3 = r35 ^ r75 ^ r115 ^ r27;
    const uint32_t t4 = r36 ^ r76 ^ r116 ^ r28;
    const uint32_t t5 = r37 ^ r77 ^ r117 ^ r29;
    const uint32_t t6 = r38 ^ r78 ^ r118 ^ r30;
    const uint32_t t7 = r39 ^ r79 ^ r119 ^ r31;
    const uint32_t u0_0 = r32 ^ r72;
    const uint32_t u0_1 = r33 ^ r73;
    const uint32_t u0_2 = r34 ^ r74;
    const uint32_t u0_3 = r35 ^ r75;
    const uint32_t u0_4 = r36 ^ r76;
    const uint32_t u0_5 = r37 ^ r77;
    const uint32_t u0_6 = r38 ^ r78;
    const uint32_t u0_7 = r39 ^ r79;
    const uint32_t u1_0 = r72 ^ r112;
    const uint32_t u1_1 = r73 ^ r113;
    const uint32_t u1_2 = r74 ^ r114;
    const uint32_t u1_3 = r75 ^ r115;
    const uint32_t u1_4 = r76 ^ r116;
    const uint32_t u1_5 = r77 ^ r117;
    const uint32_t u1_6 = r78 ^ r118;
    const uint32_t u1_7 = r79 ^ r119;
    const uint32_t u2_0 = r112 ^ r24;
    const uint32_t u2_1 = r113 ^ r25;
    const uint32_t u2_2 = r114 ^ r26;
    const uint32_t u2_3 = r115 ^ r27;
    const uint32_t u2_4 = r116 ^ r28;
    const uint32_t u2_5 = r117 ^ r29;
    const uint32_t u2_6 = r118 ^ r30;
    const uint32_t u2_7 = r119 ^ r31;
    const uint32_t u3_0 = r24 ^ r32;
    const uint32_t u3_1 = r25 ^ r33;
    const uint32_t u3_2 = r26 ^ r34;
    const uint32_t u3_3 = r27 ^ r35;
    const uint32_t u3_4 = r28 ^ r36;
    const uint32_t u3_5 = r29 ^ r37;
    const uint32_t u3_6 = r30 ^ r38;
    const uint32_t u3_7 = r31 ^ r39;
    s[32] = r32 ^ t0 ^ u0_7;
    s[33] = r33 ^ t1 ^ u0_0 ^ u0_7;
    s[34] = r34 ^ t2 ^ u0_1;
    s[35] = r35 ^ t3 ^ u0_2 ^ u0_7;
    s[36] = r36 ^ t4 ^ u0_3 ^ u0_7;
    s[37] = r37 ^ t5 ^ u0_4;
    s[38] = r38 ^ t6 ^ u0_5;
    s[39] = r39 ^ t7 ^ u0_6;
    s[40] = r72 ^ t0 ^ u1_7;
    s[41] = r73 ^ t1 ^ u1_0 ^ u1_7;
    s[42] = r74 ^ t2 ^ u1_1;
    s[43] = r75 ^ t3 ^ u1_2 ^ u1_7;
    s[44] = r76 ^ t4 ^ u1_3 ^ u1_7;
    s[45] = r77 ^ t5 ^ u1_4;
    s[46] = r78 ^ t6 ^ u1_5;
    s[47] = r79 ^ t7 ^ u1_6;
    s[48] = r112 ^ t0 ^ u2_7;
    s[49] = r113 ^ t1 ^ u2_0 ^ u2_7;
    s[50] = r114 ^ t2 ^ u2_1;
    s[51] = r115 ^ t3 ^ u2_2 ^ u2_7;
    s[52] = r116 ^ t4 ^ u2_3 ^ u2_7;
    s[53] = r117 ^ t5 ^ u2_4;
    s[54] = r118 ^ t6 ^ u2_5;
    s[55] = r119 ^ t7 ^ u2_6;
    s[56] = r24 ^ t0 ^ u3_7;
    s[57] = r25 ^ t1 ^ u3_0 ^ u3_7;
    s[58] = r26 ^ t2 ^ u3_1;
    s[59] = r27 ^ t3 ^ u3_2 ^ u3_7;
    s[60] = r28 ^ t4 ^ u3_3 ^ u3_7;
    s[61] = r29 ^ t5 ^ u3_4;
    s[62] = r30 ^ t6 ^ u3_5;
    s[63] = r31 ^ t7 ^ u3_6;
  }
  {
    const uint32_t t0 = r64 ^ r104 ^ r16 ^ r56;
    const uint32_t t1 = r65 ^ r105 ^ r17 ^ r57;
    const uint32_t t2 = r66 ^ r106 ^ r18 ^ r58;
    const uint32_t t3 = r67 ^ r107 ^ r19 ^ r59;
    const uint32_t t4 = r68 ^ r108 ^ r20 ^ r60;
    const uint32_t t5 = r69 ^ r109 ^ r21 ^ r61;
    const uint32_t t6 = r70 ^ r110 ^ r22 ^ r62;
    const uint32_t t7 = r71 ^ r111 ^ r23 ^ r63;
    const uint32_t u0_0 = r64 ^ r104;
    const uint32_t u0_1 = r65 ^ r105;
    const uint32_t u0_2 = r66 ^ r106;
    const uint32_t u0_3 = r67 ^ r107;
    const uint32_t u0_4 = r68 ^ r108;
    const uint32_t u0_5 = r69 ^ r109;
    const uint32_t u0_6 = r70 ^ r110;
    const uint32_t u0_7 = r71 ^ r111;
    const uint32_t u1_0 = r104 ^ r16;
    const uint32_t u1_1 = r105 ^ r17;
    const uint32_t u1_2 = r106 ^ r18;
    const uint32_t u1_3 = r107 ^ r19;
    const uint32_t u1_4 = r108 ^ r20;
    const uint32_t u1_5 = r109 ^ r21;
    const uint32_t u1_6 = r110 ^ r22;
    const uint32_t u1_7 = r111 ^ r23;
    const uint32_t u2_0 = r16 ^ r56;
    const uint32_t u2_1 = r17 ^ r57;
    const uint32_t u2_2 = r18 ^ r58;
    const uint32_t u2_3 = r19 ^ r59;
    const uint32_t u2_4 = r20 ^ r60;
    const uint32_t u2_5 = r21 ^ r61;
    const uint32_t u2_6 = r22 ^ r62;
    const uint32_t u2_7 = r23 ^ r63;
    const uint32_t u3_0 = r56 ^ r64;
    const uint32_t u3_1 = r57 ^ r65;
    const uint32_t u3_2 = r58 ^ r66;
    const uint32_t u3_3 = r59 ^ r67;
    const uint32_t u3_4 = r60 ^ r68;
    const uint32_t u3_5 = r61 ^ r69;
    const uint32_t u3_6 = r62 ^ r70;
    const uint32_t u3_7 = r63 ^ r71;
    s[64] = r64 ^ t0 ^ u0_7;
    s[65] = r65 ^ t1 ^ u0_0 ^ u0_7;
    s[66] = r66 ^ t2 ^ u0_1;
    s[67] = r67 ^ t3 ^ u0_2 ^ u0_7;
    s[68] = r68 ^ t4 ^ u0_3 ^ u0_7;
    s[69] = r69 ^ t5 ^ u0_4;
    s[70] = r70 ^ t6 ^ u0_5;
    s[71] = r71 ^ t7 ^ u0_6;
    s[72] = r104 ^ t0 ^ u1_7;
    s[73] = r105 ^ t1 ^ u1_0 ^ u1_7;
    s[74] = r106 ^ t2 ^ u1_1;
    s[75] = r107 ^ t3 ^ u1_2 ^ u1_7;
    s[76] = r108 ^ t4 ^ u1_3 ^ u1_7;
    s[77] = r109 ^ t5 ^ u1_4;
    s[78] = r110 ^ t6 ^ u1_5;
    s[79] = r111 ^ t7 ^ u1_6;
    s[80] = r16 ^ t0 ^ u2_7;
    s[81] = r17 ^ t1 ^ u2_0 ^ u2_7;
    s[82] = r18 ^ t2 ^ u2_1;
    s[83] = r19 ^ t3 ^ u2_2 ^ u2_7;
    s[84] = r20 ^ t4 ^ u2_3 ^ u2_7;
    s[85] = r21 ^ t5 ^ u2_4;
    s[86] = r22 ^ t6 ^ u2_5;
    s[87] = r23 ^ t7 ^ u2_6;
    s[88] = r56 ^ t0 ^ u3_7;
    s[89] = r57 ^ t1 ^ u3_0 ^ u3_7;
    s[90] = r58 ^ t2 ^ u3_1;
    s[91] = r59 ^ t3 ^ u3_2 ^ u3_7;
    s[92] = r60 ^ t4 ^ u3_3 ^ u3_7;
    s[93] = r61 ^ t5 ^ u3_4;
    s[94] = r62 ^ t6 ^ u3_5;
    s[95] = r63 ^ t7 ^ u3_6;
  }
  {
    const uint32_t t0 = r96 ^ r8 ^ r48 ^ r88;
    const uint32_t t1 = r97 ^ r9 ^ r49 ^ r89;
    const uint32_t t2 = r98 ^ r10 ^ r50 ^ r90;
    const uint32_t t3 = r99 ^ r11 ^ r51 ^ r91;
    const uint32_t t4 = r100 ^ r12 ^ r52 ^ r92;
    const uint32_t t5 = r101 ^ r13 ^ r53 ^ r93;
    const uint32_t t6 = r102 ^ r14 ^ r54 ^ r94;
    const uint32_t t7 = r103 ^ r15 ^ r55 ^ r95;
    const uint32_t u0_0 = r96 ^ r8;
    const uint32_t u0_1 = r97 ^ r9;
    const uint32_t u0_2 = r98 ^ r10;
    const uint32_t u0_3 = r99 ^ r11;
    const uint32_t u0_4 = r100 ^ r12;
    const uint32_t u0_5 = r101 ^ r13;
    const uint32_t u0_6 = r102 ^ r14;
    const uint32_t u0_7 = r103 ^ r15;
    const uint32_t u1_0 = r8 ^ r48;
    const uint32_t u1_1 = r9 ^ r49;
    const uint32_t u1_2 = r10 ^ r50;
    const uint32_t u1_3 = r11 ^ r51;
    const uint32_t u1_4 = r12 ^ r52;
    const uint32_t u1_5 = r13 ^ r53;
    const uint32_t u1_6 = r14 ^ r54;
    const uint32_t u1_7 = r15 ^ r55;
    const uint32_t u2_0 = r48 ^ r88;
    const uint32_t u2_1 = r49 ^ r89;
    const uint32_t u2_2 = r50 ^ r90;
    const uint32_t u2_3 = r51 ^ r91;
    const uint32_t u2_4 = r52 ^ r92;
    const uint32_t u2_5 = r53 ^ r93;
    const uint32_t u2_6 = r54 ^ r94;
    const uint32_t u2_7 = r55 ^ r95;
    const uint32_t u3_0 = r88 ^ r96;
    const uint32_t u3_1 = r89 ^ r97;
    const uint32_t u3_2 = r90 ^ r98;
    const uint32_t u3_3 = r91 ^ r99;
    const uint32_t u3_4 = r92 ^ r100;
    const uint32_t u3_5 = r93 ^ r101;
    const uint32_t u3_6 = r94 ^ r102;
    const uint32_t u3_7 = r95 ^ r103;
    s[96] = r96 ^ t0 ^ u0_7;
    s[97] = r97 ^ t1 ^ u0_0 ^ u0_7;
    s[98] = r98 ^ t2 ^ u0_1;
    s[99] = r99 ^ t3 ^ u0_2 ^ u0_7;
    s[100] = r100 ^ t4 ^ u0_3 ^ u0_7;
    s[101] = r101 ^ t5 ^ u0_4;
    s[102] = r102 ^ t6 ^ u0_5;
    s[103] = r103 ^ t7 ^ u0_6;
    s[104] = r8 ^ t0 ^ u1_7;
    s[105] = r9 ^ t1 ^ u1_0 ^ u1_7;
    s[106] = r10 ^ t2 ^ u1_1;
    s[107] = r11 ^ t3 ^ u1_2 ^ u1_7;
    s[108] = r12 ^ t4 ^ u1_3 ^ u1_7;
    s[109] = r13 ^ t5 ^ u1_4;
    s[110] = r14 ^ t6 ^ u1_5;
    s[111] = r15 ^ t7 ^ u1_6;
    s[112] = r48 ^ t0 ^ u2_7;
    s[113] = r49 ^ t1 ^ u2_0 ^ u2_7;
    s[114] = r50 ^ t2 ^ u2_1;
    s[115] = r51 ^ t3 ^ u2_2 ^ u2_7;
    s[116] = r52 ^ t4 ^ u2_3 ^ u2_7;
    s[117] = r53 ^ t5 ^ u2_4;
    s[118] = r54 ^ t6 ^ u2_5;
    s[119] = r55 ^ t7 ^ u2_6;
    s[120] = r88 ^ t0 ^ u3_7;
    s[121] = r89 ^ t1 ^ u3_0 ^ u3_7;
    s[122] = r90 ^ t2 ^ u3_1;
    s[123] = r91 ^ t3 ^ u3_2 ^ u3_7;
    s[124] = r92 ^ t4 ^ u3_3 ^ u3_7;
    s[125] = r93 ^ t5 ^ u3_4;
    s[126] = r94 ^ t6 ^ u3_5;
    s[127] = r95 ^ t7 ^ u3_6;
  }
}

// AddRoundKey with a fixed key: a set key bit flips its plane.
constexpr int kKeyLeft = 0;
constexpr int kKeyRight = 1;
constexpr int kKeyValue = 2;
__device__ __forceinline__ void add_round_key(uint32_t (&s)[128], int key, int rnd) {
  switch (key * 11 + rnd) {
    case 0: s[1] = ~s[1]; s[6] = ~s[6]; s[7] = ~s[7]; s[8] = ~s[8]; s[9] = ~s[9]; s[11] = ~s[11]; s[12] = ~s[12]; s[13] = ~s[13]; s[18] = ~s[18]; s[21] = ~s[21]; s[22] = ~s[22]; s[23] = ~s[23]; s[27] = ~s[27]; s[28] = ~s[28]; s[29] = ~s[29]; s[30] = ~s[30]; s[33] = ~s[33]; s[35] = ~s[35]; s[36] = ~s[36]; s[37] = ~s[37]; s[38] = ~s[38]; s[39] = ~s[39]; s[43] = ~s[43]; s[44] = ~s[44]; s[45] = ~s[45]; s[47] = ~s[47]; s[48] = ~s[48]; s[49] = ~s[49]; s[52] = ~s[52]; s[53] = ~s[53]; s[54] = ~s[54]; s[55] = ~s[55]; s[56] = ~s[56]; s[57] = ~s[57]; s[58] = ~s[58]; s[59] = ~s[59]; s[61] = ~s[61]; s[62] = ~s[62]; s[65] = ~s[65]; s[66] = ~s[66]; s[67] = ~s[67]; s[68] = ~s[68]; s[69] = ~s[69]; s[70] = ~s[70]; s[71] = ~s[71]; s[74] = ~s[74]; s[76] = ~s[76]; s[77] = ~s[77]; s[78] = ~s[78]; s[79] = ~s[79]; s[80] = ~s[80]; s[83] = ~s[83]; s[84] = ~s[84]; s[85] = ~s[85]; s[86] = ~s[86]; s[87] = ~s[87]; s[91] = ~s[91]; s[93] = ~s[93]; s[94] = ~s[94]; s[96] = ~s[96]; s[100] = ~s[100]; s[101] = ~s[101]; s[103] = ~s[103]; s[107] = ~s[107]; s[108] = ~s[108]; s[109] = ~s[109]; s[112] = ~s[112]; s[114] = ~s[114]; s[115] = ~s[115]; s[116] = ~s[116]; s[119] = ~s[119]; s[120] = ~s[120]; s[124] = ~s[124]; s[125] = ~s[125]; break;
    case 1: s[2] = ~s[2]; s[6] = ~s[6]; s[7] = ~s[7]; s[8] = ~s[8]; s[10] = ~s[10]; s[13] = ~s[13]; s[14] = ~s[14]; s[16] = ~s[16]; s[17] = ~s[17]; s[21] = ~s[21]; s[28] = ~s[28]; s[29] = ~s[29]; s[31] = ~s[31]; s[33] = ~s[33]; s[34] = ~s[34]; s[35] = ~s[35]; s[36] = ~s[36]; s[37] = ~s[37]; s[40] = ~s[40]; s[42] = ~s[42]; s[43] = ~s[43]; s[44] = ~s[44]; s[46] = ~s[46]; s[47] = ~s[47]; s[52] = ~s[52]; s[54] = ~s[54]; s[55] = ~s[55]; s[56] = ~s[56]; s[57] = ~s[57]; s[58] = ~s[58]; s[59] = ~s[59]; s[60] = ~s[60]; s[62] = ~s[62]; s[63] = ~s[63]; s[70] = ~s[70]; s[71] = ~s[71]; s[72] = ~s[72]; s[75] = ~s[75]; s[77] = ~s[77]; s[80] = ~s[80]; s[83] = ~s[83]; s[85] = ~s[85]; s[88] = ~s[88]; s[89] = ~s[89]; s[90] = ~s[90]; s[92] = ~s[92]; s[93] = ~s[93]; s[95] = ~s[95]; s[96] = ~s[96]; s[100] = ~s[100]; s[101] = ~s[101]; s[102] = ~s[102]; s[104] = ~s[104]; s[108] = ~s[108]; s[114] = ~s[114]; s[116] = ~s[116]; s[117] = ~s[117]; s[119] = ~s[119]; s[121] = ~s[121]; s[122] = ~s[122]; s[127] = ~s[127]; break;
    case 2: s[2] = ~s[2]; s[6] = ~s[6]; s[11] = ~s[11]; s[13] = ~s[13]; s[14] = ~s[14]; s[15] = ~s[15]; s[16] = ~s[16]; s[17] = ~s[17]; s[18] = ~s[18]; s[21] = ~s[21]; s[22] = ~s[22]; s[24] = ~s[24]; s[25] = ~s[25]; s[28] = ~s[28]; s[33] = ~s[33]; s[35] = ~s[35]; s[36] = ~s[36]; s[37] = ~s[37]; s[38] = ~s[38]; s[40] = ~s[40]; s[42] = ~s[42]; s[44] = ~s[44]; s[45] = ~s[45]; s[48] = ~s[48]; s[49] = ~s[49]; s[50] = ~s[50]; s[52] = ~s[52]; s[53] = ~s[53]; s[55] = ~s[55]; s[58] = ~s[58]; s[59] = ~s[59]; s[62] = ~s[62]; s[63] = ~s[63]; s[65] = ~s[65]; s[67] = ~s[67]; s[68] = ~s[68]; s[69] = ~s[69]; s[71] = ~s[71]; s[74] = ~s[74]; s[75] = ~s[75]; s[76] = ~s[76]; s[81] = ~s[81]; s[82] = ~s[82]; s[83] = ~s[83]; s[84] = ~s[84]; s[87] = ~s[87]; s[88] = ~s[88]; s[89] = ~s[89]; s[91] = ~s[91]; s[92] = ~s[92]; s[93] = ~s[93]; s[94] = ~s[94]; s[96] = ~s[96]; s[97] = ~s[97]; s[99] = ~s[99]; s[102] = ~s[102]; s[103] = ~s[103]; s[104] = ~s[104]; s[106] = ~s[106]; s[107] = ~s[107]; s[113] = ~s[113]; s[115] = ~s[115]; s[117] = ~s[117]; s[120] = ~s[120]; s[122] = ~s[122]; s[123] = ~s[123]; s[124] = ~s[124]; s[125] = ~s[125]; s[126] = ~s[126]; s[127] = ~s[127]; break;
    case 3: s[0] = ~s[0]; s[1] = ~s[1]; s[2] = ~s[2]; s[4] = ~s[4]; s[7] = ~s[7]; s[8] = ~s[8]; s[10] = ~s[10]; s[11] = ~s[11]; s[16] = ~s[16]; s[17] = ~s[17]; s[20] = ~s[20]; s[21] = ~s[21]; s[26] = ~s[26]; s[27] = ~s[27]; s[32] = ~s[32]; s[34] = ~s[34]; s[35] = ~s[35]; s[37] = ~s[37]; s[38] = ~s[38]; s[39] = ~s[39]; s[43] = ~s[43]; s[44] = ~s[44]; s[45] = ~s[45]; s[50] = ~s[50]; s[55] = ~s[55]; s[62] = ~s[62]; s[63] = ~s[63]; s[64] = ~s[64]; s[65] = ~s[65]; s[66] = ~s[66]; s[68] = ~s[68]; s[70] = ~s[70]; s[74] = ~s[74]; s[77] = ~s[77]; s[81] = ~s[81]; s[83] = ~s[83]; s[84] = ~s[84]; s[88] = ~s[88]; s[89] = ~s[89]; s[91] = ~s[91]; s[92] = ~s[92]; s[93] = ~s[93]; s[95] = ~s[95]; s[98] = ~s[98]; s[99] = ~s[99]; s[100] = ~s[100]; s[103] = ~s[103]; s[104] = ~s[104]; s[107] = ~s[107]; s[109] = ~s[109]; s[116] = ~s[116]; s[117] = ~s[117]; s[121] = ~s[121]; s[122] = ~s[122]; s[126] = ~s[126]; break;
    case 4: s[1] = ~s[1]; s[3] = ~s[3]; s[4] = ~s[4]; s[5] = ~s[5]; s[8] = ~s[8]; s[11] = ~s[11]; s[16] = ~s[16]; s[19] = ~s[19]; s[21] = ~s[21]; s[22] = ~s[22]; s[25] = ~s[25]; s[28] = ~s[28]; s[30] = ~s[30]; s[31] = ~s[31]; s[32] = ~s[32]; s[33] = ~s[33]; s[34] = ~s[34]; s[36] = ~s[36]; s[38] = ~s[38]; s[39] = ~s[39]; s[40] = ~s[40]; s[44] = ~s[44]; s[45] = ~s[45]; s[48] = ~s[48]; s[50] = ~s[50]; s[51] = ~s[51]; s[53] = ~s[53]; s[54] = ~s[54]; s[55] = ~s[55]; s[57] = ~s[57]; s[60] = ~s[60]; s[71] = ~s[71]; s[72] = ~s[72]; s[74] = ~s[74]; s[76] = ~s[76]; s[80] = ~s[80]; s[81] = ~s[81]; s[82] = ~s[82]; s[84] = ~s[84]; s[85] = ~s[85]; s[86] = ~s[86]; s[87] = ~s[87]; s[88] = ~s[88]; s[91] = ~s[91]; s[93] = ~s[93]; s[95] = ~s[95]; s[98] = ~s[98]; s[99] = ~s[99]; s[100] = ~s[100]; s[106] = ~s[106]; s[107] = ~s[107]; s[108] = ~s[108]; s[109] = ~s[109]; s[112] = ~s[112]; s[113] = ~s[113]; s[114] = ~s[114]; s[118] = ~s[118]; s[119] = ~s[119]; s[120] = ~s[120]; s[121] = ~s[121]; s[122] = ~s[122]; s[123] = ~s[123]; s[125] = ~s[125]; s[126] = ~s[126]; s[127] = ~s[127]; break;
    case 5: s[0] = ~s[0]; s[6] = ~s[6]; s[7] = ~s[7]; s[8] = ~s[8]; s[9] = ~s[9]; s[10] = ~s[10]; s[11] = ~s[11]; s[14] = ~s[14]; s[15] = ~s[15]; s[17] = ~s[17]; s[18] = ~s[18]; s[20] = ~s[20]; s[21] = ~s[21]; s[23] = ~s[23]; s[25] = ~s[25]; s[26] = ~s[26]; s[27] = ~s[27]; s[30] = ~s[30]; s[33] = ~s[33]; s[34] = ~s[34]; s[36] = ~s[36]; s[41] = ~s[41]; s[42] = ~s[42]; s[43] = ~s[43]; s[44] = ~s[44]; s[45] = ~s[45]; s[46] = ~s[46]; s[47] = ~s[47]; s[48] = ~s[48]; s[49] = ~s[49]; s[51] = ~s[51]; s[52] = ~s[52]; s[54] = ~s[54]; s[58] = ~s[58]; s[59] = ~s[59]; s[60] = ~s[60]; s[62] = ~s[62]; s[65] = ~s[65]; s[66] = ~s[66]; s[68] = ~s[68]; s[71] = ~s[71]; s[72] = ~s[72]; s[73] = ~s[73]; s[75] = ~s[75]; s[77] = ~s[77]; s[78] = ~s[78]; s[79] = ~s[79]; s[82] = ~s[82]; s[83] = ~s[83]; s[85] = ~s[85]; s[87] = ~s[87]; s[88] = ~s[88]; s[90] = ~s[90]; s[92] = ~s[92]; s[93] = ~s[93]; s[94] = ~s[94]; s[95] = ~s[95]; s[97] = ~s[97]; s[99] = ~s[99]; s[103] = ~s[103]; s[104] = ~s[104]; s[105] = ~s[105]; s[106] = ~s[106]; s[108] = ~s[108]; s[110] = ~s[110]; s[111] = ~s[111]; s[112] = ~s[112]; s[113] = ~s[113]; s[115] = ~s[115]; s[117] = ~s[117]; s[118] = ~s[118]; s[121] = ~s[121]; s[123] = ~s[123]; s[124] = ~s[124]; break;
    case 6: s[0] = ~s[0]; s[1] = ~s[1]; s[2] = ~s[2]; s[3] = ~s[3]; s[5] = ~s[5]; s[6] = ~s[6]; s[7] = ~s[7]; s[12] = ~s[12]; s[13] = ~s[13]; s[15] = ~s[15]; s[18] = ~s[18]; s[20] = ~s[20]; s[28] = ~s[28]; s[29] = ~s[29]; s[32] = ~s[32]; s[35] = ~s[35]; s[36] = ~s[36]; s[37] = ~s[37]; s[38] = ~s[38]; s[39] = ~s[39]; s[41] = ~s[41]; s[42] = ~s[42]; s[43] = ~s[43]; s[46] = ~s[46]; s[48] = ~s[48]; s[49] = ~s[49]; s[50] = ~s[50]; s[51] = ~s[51]; s[54] = ~s[54]; s[58] = ~s[58]; s[59] = ~s[59]; s[61] = ~s[61]; s[62] = ~s[62]; s[64] = ~s[64]; s[65] = ~s[65]; s[66] = ~s[66]; s[67] = ~s[67]; s[69] = ~s[69]; s[70] = ~s[70]; s[72] = ~s[72]; s[74] = ~s[74]; s[77] = ~s[77]; s[79] = ~s[79]; s[80] = ~s[80]; s[81] = ~s[81]; s[85] = ~s[85]; s[86] = ~s[86]; s[87] = ~s[87]; s[88] = ~s[88]; s[91] = ~s[91]; s[92] = ~s[92]; s[95] = ~s[95]; s[96] = ~s[96]; s[98] = ~s[98]; s[101] = ~s[101]; s[102] = ~s[102]; s[103] = ~s[103]; s[105] = ~s[105]; s[108] = ~s[108]; s[109] = ~s[109]; s[110] = ~s[110]; s[115] = ~s[115]; s[119] = ~s[119]; s[120] = ~s[120]; s[121] = ~s[121]; s[127] = ~s[127]; break;
    case 7: s[0] = ~s[0]; s[1] = ~s[1]; s[2] = ~s[2]; s[3] = ~s[3]; s[5] = ~s[5]; s[6] = ~s[6]; s[7] = ~s[7]; s[10] = ~s[10]; s[12] = ~s[12]; s[13] = ~s[13]; s[14] = ~s[14]; s[19] = ~s[19]; s[20] = ~s[20]; s[21] = ~s[21]; s[22] = ~s[22]; s[23] = ~s[23]; s[24] = ~s[24]; s[27] = ~s[27]; s[29] = ~s[29]; s[30] = ~s[30]; s[31] = ~s[31]; s[33] = ~s[33]; s[34] = ~s[34]; s[36] = ~s[36]; s[41] = ~s[41]; s[43] = ~s[43]; s[44] = ~s[44]; s[45] = ~s[45]; s[48] = ~s[48]; s[49] = ~s[49]; s[50] = ~s[50]; s[52] = ~s[52]; s[53] = ~s[53]; s[55] = ~s[55]; s[56] = ~s[56]; s[58] = ~s[58]; s[63] = ~s[63]; s[64] = ~s[64]; s[67] = ~s[67]; s[68] = ~s[68]; s[69] = ~s[69]; s[70] = ~s[70]; s[72] = ~s[72]; s[73] = ~s[73]; s[74] = ~s[74]; s[75] = ~s[75]; s[76] = ~s[76]; s[79] = ~s[79]; s[82] = ~s[82]; s[84] = ~s[84]; s[86] = ~s[86]; s[90] = ~s[90]; s[91] = ~s[91]; s[92] = ~s[92]; s[98] = ~s[98]; s[99] = ~s[99]; s[100] = ~s[100]; s[103] = ~s[103]; s[104] = ~s[104]; s[106] = ~s[106]; s[107] = ~s[107]; s[109] = ~s[109]; s[110] = ~s[110]; s[111] = ~s[111]; s[114] = ~s[114]; s[115] = ~s[115]; s[116] = ~s[116]; s[118] = ~s[118]; s[119] = ~s[119]; s[120] = ~s[120]; s[121] = ~s[121]; s[122] = ~s[122]; s[123] = ~s[123]; s[124] = ~s[124]; s[127] = ~s[127]; break;
    case 8: s[1] = ~s[1]; s[3] = ~s[3]; s[4] = ~s[4]; s[5] = ~s[5]; s[9] = ~s[9]; s[12] = ~s[12]; s[13] = ~s[13]; s[14] = ~s[14]; s[15] = ~s[15]; s[16] = ~s[16]; s[17] = ~s[17]; s[21] = ~s[21]; s[24] = ~s[24]; s[25] = ~s[25]; s[26] = ~s[26]; s[28] = ~s[28]; s[29] = ~s[29]; s[34] = ~s[34]; s[35] = ~s[35]; s[37] = ~s[37]; s[43] = ~s[43]; s[46] = ~s[46]; s[47] = ~s[47]; s[50] = ~s[50]; s[52] = ~s[52]; s[55] = ~s[55]; s[57] = ~s[57]; s[60] = ~s[60]; s[61] = ~s[61]; s[63] = ~s[63]; s[64] = ~s[64]; s[66] = ~s[66]; s[68] = ~s[68]; s[70] = ~s[70]; s[72] = ~s[72]; s[73] = ~s[73]; s[74] = ~s[74]; s[76] = ~s[76]; s[78] = ~s[78]; s[86] = ~s[86]; s[87] = ~s[87]; s[89] = ~s[89]; s[90] = ~s[90]; s[91] = ~s[91]; s[93] = ~s[93]; s[95] = ~s[95]; s[96] = ~s[96]; s[99] = ~s[99]; s[102] = ~s[102]; s[103] = ~s[103]; s[105] = ~s[105]; s[107] = ~s[107]; s[108] = ~s[108]; s[109] = ~s[109]; s[111] = ~s[111]; s[114] = ~s[114]; s[115] = ~s[115]; s[116] = ~s[116]; s[120] = ~s[120]; s[124] = ~s[124]; s[125] = ~s[125]; break;
    case 9: s[0] = ~s[0]; s[2] = ~s[2]; s[4] = ~s[4]; s[6] = ~s[6]; s[7] = ~s[7]; s[9] = ~s[9]; s[10] = ~s[10]; s[11] = ~s[11]; s[13] = ~s[13]; s[14] = ~s[14]; s[18] = ~s[18]; s[21] = ~s[21]; s[22] = ~s[22]; s[23] = ~s[23]; s[25] = ~s[25]; s[27] = ~s[27]; s[29] = ~s[29]; s[30] = ~s[30]; s[31] = ~s[31]; s[32] = ~s[32]; s[35] = ~s[35]; s[36] = ~s[36]; s[37] = ~s[37]; s[38] = ~s[38]; s[39] = ~s[39]; s[41] = ~s[41]; s[42] = ~s[42]; s[45] = ~s[45]; s[47] = ~s[47]; s[52] = ~s[52]; s[53] = ~s[53]; s[54] = ~s[54]; s[59] = ~s[59]; s[60] = ~s[60]; s[62] = ~s[62]; s[66] = ~s[66]; s[67] = ~s[67]; s[69] = ~s[69]; s[71] = ~s[71]; s[72] = ~s[72]; s[76] = ~s[76]; s[77] = ~s[77]; s[78] = ~s[78]; s[79] = ~s[79]; s[84] = ~s[84]; s[85] = ~s[85]; s[87] = ~s[87]; s[89] = ~s[89]; s[90] = ~s[90]; s[92] = ~s[92]; s[93] = ~s[93]; s[94] = ~s[94]; s[95] = ~s[95]; s[96] = ~s[96]; s[98] = ~s[98]; s[101] = ~s[101]; s[102] = ~s[102]; s[104] = ~s[104]; s[105] = ~s[105]; s[107] = ~s[107]; s[110] = ~s[110]; s[114] = ~s[114]; s[115] = ~s[115]; s[117] = ~s[117]; s[119] = ~s[119]; s[120] = ~s[120]; s[121] = ~s[121]; s[122] = ~s[122]; s[126] = ~s[126]; s[127] = ~s[127]; break;
    case 10: s[4] = ~s[4]; s[6] = ~s[6]; s[8] = ~s[8]; s[9] = ~s[9]; s[10] = ~s[10]; s[11] = ~s[11]; s[12] = ~s[12]; s[13] = ~s[13]; s[14] = ~s[14]; s[15] = ~s[15]; s[17] = ~s[17]; s[21] = ~s[21]; s[24] = ~s[24]; s[25] = ~s[25]; s[26] = ~s[26]; s[29] = ~s[29]; s[31] = ~s[31]; s[32] = ~s[32]; s[35] = ~s[35]; s[37] = ~s[37]; s[39] = ~s[39]; s[40] = ~s[40]; s[43] = ~s[43]; s[44] = ~s[44]; s[46] = ~s[46]; s[49] = ~s[49]; s[52] = ~s[52]; s[54] = ~s[54]; s[56] = ~s[56]; s[57] = ~s[57]; s[58] = ~s[58]; s[59] = ~s[59]; s[60] = ~s[60]; s[61] = ~s[61]; s[62] = ~s[62]; s[63] = ~s[63]; s[64] = ~s[64]; s[66] = ~s[66]; s[75] = ~s[75]; s[77] = ~s[77]; s[79] = ~s[79]; s[81] = ~s[81]; s[85] = ~s[85]; s[86] = ~s[86]; s[87] = ~s[87]; s[88] = ~s[88]; s[91] = ~s[91]; s[101] = ~s[101]; s[102] = ~s[102]; s[104] = ~s[104]; s[105] = ~s[105]; s[109] = ~s[109]; s[110] = ~s[110]; s[111] = ~s[111]; s[113] = ~s[113]; s[114] = ~s[114]; s[115] = ~s[115]; s[118] = ~s[118]; s[121] = ~s[121]; s[122] = ~s[122]; s[123] = ~s[123]; s[126] = ~s[126]; s[127] = ~s[127]; break;
    case 11: s[1] = ~s[1]; s[2] = ~s[2]; s[5] = ~s[5]; s[6] = ~s[6]; s[9] = ~s[9]; s[10] = ~s[10]; s[13] = ~s[13]; s[15] = ~s[15]; s[16] = ~s[16]; s[19] = ~s[19]; s[20] = ~s[20]; s[25] = ~s[25]; s[27] = ~s[27]; s[30] = ~s[30]; s[32] = ~s[32]; s[33] = ~s[33]; s[35] = ~s[35]; s[37] = ~s[37]; s[39] = ~s[39]; s[41] = ~s[41]; s[44] = ~s[44]; s[46] = ~s[46]; s[48] = ~s[48]; s[49] = ~s[49]; s[52] = ~s[52]; s[53] = ~s[53]; s[54] = ~s[54]; s[55] = ~s[55]; s[56] = ~s[56]; s[57] = ~s[57]; s[61] = ~s[61]; s[66] = ~s[66]; s[69] = ~s[69]; s[70] = ~s[70]; s[71] = ~s[71]; s[75] = ~s[75]; s[76] = ~s[76]; s[77] = ~s[77]; s[79] = ~s[79]; s[82] = ~s[82]; s[83] = ~s[83]; s[87] = ~s[87]; s[91] = ~s[91]; s[92] = ~s[92]; s[93] = ~s[93]; s[94] = ~s[94]; s[95] = ~s[95]; s[98] = ~s[98]; s[99] = ~s[99]; s[101] = ~s[101]; s[106] = ~s[106]; s[107] = ~s[107]; s[109] = ~s[109]; s[115] = ~s[115]; s[120] = ~s[120]; break;
    case 12: s[1] = ~s[1]; s[2] = ~s[2]; s[4] = ~s[4]; s[9] = ~s[9]; s[10] = ~s[10]; s[12] = ~s[12]; s[15] = ~s[15]; s[16] = ~s[16]; s[18] = ~s[18]; s[21] = ~s[21]; s[22] = ~s[22]; s[24] = ~s[24]; s[25] = ~s[25]; s[27] = ~s[27]; s[28] = ~s[28]; s[29] = ~s[29]; s[32] = ~s[32]; s[34] = ~s[34]; s[35] = ~s[35]; s[36] = ~s[36]; s[37] = ~s[37]; s[39] = ~s[39]; s[42] = ~s[42]; s[46] = ~s[46]; s[47] = ~s[47]; s[49] = ~s[49]; s[50] = ~s[50]; s[52] = ~s[52]; s[55] = ~s[55]; s[59] = ~s[59]; s[60] = ~s[60]; s[64] = ~s[64]; s[67] = ~s[67]; s[68] = ~s[68]; s[70] = ~s[70]; s[74] = ~s[74]; s[75] = ~s[75]; s[76] = ~s[76]; s[77] = ~s[77]; s[78] = ~s[78]; s[81] = ~s[81]; s[83] = ~s[83]; s[84] = ~s[84]; s[93] = ~s[93]; s[94] = ~s[94]; s[95] = ~s[95]; s[96] = ~s[96]; s[98] = ~s[98]; s[100] = ~s[100]; s[101] = ~s[101]; s[102] = ~s[102]; s[108] = ~s[108]; s[110] = ~s[110]; s[113] = ~s[113]; s[116] = ~s[116]; s[120] = ~s[120]; s[125] = ~s[125]; s[126] = ~s[126]; s[127] = ~s[127]; break;
    case 13: s[0] = ~s[0]; s[1] = ~s[1]; s[2] = ~s[2]; s[6] = ~s[6]; s[8] = ~s[8]; s[9] = ~s[9]; s[10] = ~s[10]; s[11] = ~s[11]; s[12] = ~s[12]; s[14] = ~s[14]; s[16] = ~s[16]; s[18] = ~s[18]; s[19] = ~s[19]; s[20] = ~s[20]; s[23] = ~s[23]; s[25] = ~s[25]; s[26] = ~s[26]; s[29] = ~s[29]; s[31] = ~s[31]; s[33] = ~s[33]; s[35] = ~s[35]; s[36] = ~s[36]; s[37] = ~s[37]; s[38] = ~s[38]; s[39] = ~s[39]; s[40] = ~s[40]; s[41] = ~s[41]; s[43] = ~s[43]; s[44] = ~s[44]; s[47] = ~s[47]; s[48] = ~s[48]; s[49] = ~s[49]; s[51] = ~s[51]; s[57] = ~s[57]; s[58] = ~s[58]; s[59] = ~s[59]; s[60] = ~s[60]; s[61] = ~s[61]; s[63] = ~s[63]; s[64] = ~s[64]; s[65] = ~s[65]; s[69] = ~s[69]; s[71] = ~s[71]; s[72] = ~s[72]; s[73] = ~s[73]; s[74] = ~s[74]; s[77] = ~s[77]; s[78] = ~s[78]; s[79] = ~s[79]; s[80] = ~s[80]; s[84] = ~s[84]; s[89] = ~s[89]; s[90] = ~s[90]; s[91] = ~s[91]; s[92] = ~s[92]; s[94] = ~s[94]; s[97] = ~s[97]; s[98] = ~s[98]; s[100] = ~s[100]; s[102] = ~s[102]; s[103] = ~s[103]; s[104] = ~s[104]; s[105] = ~s[105]; s[106] = ~s[106]; s[108] = ~s[108]; s[109] = ~s[109]; s[111] = ~s[111]; s[112] = ~s[112]; s[113] = ~s[113]; s[120] = ~s[120]; s[121] = ~s[121]; s[122] = ~s[122]; s[123] = ~s[123]; s[124] = ~s[124]; s[125] = ~s[125]; s[127] = ~s[127]; break;
    case 14: s[1] = ~s[1]; s[3] = ~s[3]; s[5] = ~s[5]; s[6] = ~s[6]; s[7] = ~s[7]; s[10] = ~s[10]; s[13] = ~s[13]; s[16] = ~s[16]; s[18] = ~s[18]; s[20] = ~s[20]; s[23] = ~s[23]; s[28] = ~s[28]; s[30] = ~s[30]; s[36] = ~s[36]; s[40] = ~s[40]; s[41] = ~s[41]; s[42] = ~s[42]; s[43] = ~s[43]; s[44] = ~s[44]; s[45] = ~s[45]; s[47] = ~s[47]; s[49] = ~s[49]; s[50] = ~s[50]; s[51] = ~s[51]; s[52] = ~s[52]; s[55] = ~s[55]; s[57] = ~s[57]; s[58] = ~s[58]; s[59] = ~s[59]; s[61] = ~s[61]; s[62] = ~s[62]; s[63] = ~s[63]; s[64] = ~s[64]; s[65] = ~s[65]; s[68] = ~s[68]; s[69] = ~s[69]; s[71] = ~s[71]; s[75] = ~s[75]; s[76] = ~s[76]; s[78] = ~s[78]; s[80] = ~s[80]; s[81] = ~s[81]; s[82] = ~s[82]; s[83] = ~s[83]; s[87] = ~s[87]; s[92] = ~s[92]; s[93] = ~s[93]; s[95] = ~s[95]; s[96] = ~s[96]; s[98] = ~s[98]; s[101] = ~s[101]; s[102] = ~s[102]; s[104] = ~s[104]; s[105] = ~s[105]; s[106] = ~s[106]; s[107] = ~s[107]; s[109] = ~s[109]; s[110] = ~s[110]; s[111] = ~s[111]; s[114] = ~s[114]; s[115] = ~s[115]; s[119] = ~s[119]; s[120] = ~s[120]; s[121] = ~s[121]; s[122] = ~s[122]; s[123] = ~s[123]; break;
    case 15: s[0] = ~s[0]; s[2] = ~s[2]; s[3] = ~s[3]; s[4] = ~s[4]; s[5] = ~s[5]; s[14] = ~s[14]; s[16] = ~s[16]; s[17] = ~s[17]; s[21] = ~s[21]; s[22] = ~s[22]; s[23] = ~s[23]; s[24] = ~s[24]; s[26] = ~s[26]; s[27] = ~s[27]; s[28] = ~s[28]; s[32] = ~s[32]; s[34] = ~s[34]; s[35] = ~s[35]; s[37] = ~s[37]; s[40] = ~s[40]; s[41] = ~s[41]; s[42] = ~s[42]; s[43] = ~s[43]; s[44] = ~s[44]; s[45] = ~s[45]; s[46] = ~s[46]; s[47] = ~s[47]; s[48] = ~s[48]; s[50] = ~s[50]; s[51] = ~s[51]; s[52] = ~s[52]; s[53] = ~s[53]; s[54] = ~s[54]; s[56] = ~s[56]; s[57] = ~s[57]; s[60] = ~s[60]; s[61] = ~s[61]; s[62] = ~s[62]; s[63] = ~s[63]; s[65] = ~s[65]; s[66] = ~s[66]; s[67] = ~s[67]; s[68] = ~s[68]; s[71] = ~s[71]; s[72] = ~s[72]; s[73] = ~s[73]; s[74] = ~s[74]; s[77] = ~s[77]; s[79] = ~s[79]; s[81] = ~s[81]; s[84] = ~s[84]; s[85] = ~s[85]; s[86] = ~s[86]; s[87] = ~s[87]; s[88] = ~s[88]; s[89] = ~s[89]; s[94] = ~s[94]; s[96] = ~s[96]; s[97] = ~s[97]; s[99] = ~s[99]; s[100] = ~s[100]; s[101] = ~s[101]; s[102] = ~s[102]; s[103] = ~s[103]; s[107] = ~s[107]; s[110] = ~s[110]; s[113] = ~s[113]; s[114] = ~s[114]; s[115] = ~s[115]; s[116] = ~s[116]; s[117] = ~s[117]; s[118] = ~s[118]; s[122] = ~s[122]; s[123] = ~s[123]; s[126] = ~s[126]; break;
    case 16: s[0] = ~s[0]; s[1] = ~s[1]; s[2] = ~s[2]; s[3] = ~s[3]; s[4] = ~s[4]; s[5] = ~s[5]; s[6] = ~s[6]; s[8] = ~s[8]; s[9] = ~s[9]; s[12] = ~s[12]; s[13] = ~s[13]; s[15] = ~s[15]; s[17] = ~s[17]; s[19] = ~s[19]; s[22] = ~s[22]; s[23] = ~s[23]; s[25] = ~s[25]; s[28] = ~s[28]; s[33] = ~s[33]; s[36] = ~s[36]; s[38] = ~s[38]; s[42] = ~s[42]; s[43] = ~s[43]; s[46] = ~s[46]; s[48] = ~s[48]; s[49] = ~s[49]; s[50] = ~s[50]; s[52] = ~s[52]; s[53] = ~s[53]; s[55] = ~s[55]; s[56] = ~s[56]; s[61] = ~s[61]; s[62] = ~s[62]; s[63] = ~s[63]; s[66] = ~s[66]; s[67] = ~s[67]; s[70] = ~s[70]; s[71] = ~s[71]; s[72] = ~s[72]; s[73] = ~s[73]; s[75] = ~s[75]; s[77] = ~s[77]; s[78] = ~s[78]; s[79] = ~s[79]; s[80] = ~s[80]; s[82] = ~s[82]; s[86] = ~s[86]; s[89] = ~s[89]; s[93] = ~s[93]; s[95] = ~s[95]; s[96] = ~s[96]; s[97] = ~s[97]; s[98] = ~s[98]; s[100] = ~s[100]; s[101] = ~s[101]; s[104] = ~s[104]; s[105] = ~s[105]; s[109] = ~s[109]; s[111] = ~s[111]; s[112] = ~s[112]; s[113] = ~s[113]; s[115] = ~s[115]; s[116] = ~s[116]; s[117] = ~s[117]; s[121] = ~s[121]; s[122] = ~s[122]; s[123] = ~s[123]; s[125] = ~s[125]; s[126] = ~s[126]; s[127] = ~s[127]; break;
    case 17: s[0] = ~s[0]; s[2] = ~s[2]; s[4] = ~s[4]; s[6] = ~s[6]; s[8] = ~s[8]; s[12] = ~s[12]; s[14] = ~s[14]; s[17] = ~s[17]; s[21] = ~s[21]; s[22] = ~s[22]; s[23] = ~s[23]; s[27] = ~s[27]; s[31] = ~s[31]; s[32] = ~s[32]; s[33] = ~s[33]; s[34] = ~s[34]; s[40] = ~s[40]; s[42] = ~s[42]; s[43] = ~s[43]; s[44] = ~s[44]; s[48] = ~s[48]; s[50] = ~s[50]; s[52] = ~s[52]; s[54] = ~s[54]; s[56] = ~s[56]; s[59] = ~s[59]; s[61] = ~s[61]; s[62] = ~s[62]; s[64] = ~s[64]; s[65] = ~s[65]; s[67] = ~s[67]; s[70] = ~s[70]; s[71] = ~s[71]; s[73] = ~s[73]; s[74] = ~s[74]; s[76] = ~s[76]; s[77] = ~s[77]; s[78] = ~s[78]; s[79] = ~s[79]; s[84] = ~s[84]; s[88] = ~s[88]; s[89] = ~s[89]; s[91] = ~s[91]; s[94] = ~s[94]; s[95] = ~s[95]; s[98] = ~s[98]; s[99] = ~s[99]; s[100] = ~s[100]; s[101] = ~s[101]; s[102] = ~s[102]; s[103] = ~s[103]; s[104] = ~s[104]; s[106] = ~s[106]; s[108] = ~s[108]; s[110] = ~s[110]; s[112] = ~s[112]; s[113] = ~s[113]; s[115] = ~s[115]; s[117] = ~s[117]; s[120] = ~s[120]; s[122] = ~s[122]; s[125] = ~s[125]; break;
    case 18: s[0] = ~s[0]; s[3] = ~s[3]; s[5] = ~s[5]; s[6] = ~s[6]; s[7] = ~s[7]; s[13] = ~s[13]; s[15] = ~s[15]; s[16] = ~s[16]; s[18] = ~s[18]; s[19] = ~s[19]; s[20] = ~s[20]; s[22] = ~s[22]; s[23] = ~s[23]; s[27] = ~s[27]; s[28] = ~s[28]; s[29] = ~s[29]; s[33] = ~s[33]; s[34] = ~s[34]; s[35] = ~s[35]; s[37] = ~s[37]; s[38] = ~s[38]; s[39] = ~s[39]; s[40] = ~s[40]; s[42] = ~s[42]; s[43] = ~s[43]; s[44] = ~s[44]; s[45] = ~s[45]; s[47] = ~s[47]; s[51] = ~s[51]; s[55] = ~s[55]; s[56] = ~s[56]; s[60] = ~s[60]; s[62] = ~s[62]; s[64] = ~s[64]; s[66] = ~s[66]; s[69] = ~s[69]; s[72] = ~s[72]; s[73] = ~s[73]; s[75] = ~s[75]; s[78] = ~s[78]; s[83] = ~s[83]; s[84] = ~s[84]; s[87] = ~s[87]; s[89] = ~s[89]; s[91] = ~s[91]; s[92] = ~s[92]; s[95] = ~s[95]; s[96] = ~s[96]; s[99] = ~s[99]; s[100] = ~s[100]; s[102] = ~s[102]; s[103] = ~s[103]; s[105] = ~s[105]; s[106] = ~s[106]; s[107] = ~s[107]; s[108] = ~s[108]; s[112] = ~s[112]; s[113] = ~s[113]; s[116] = ~s[116]; s[117] = ~s[117]; s[119] = ~s[119]; s[120] = ~s[120]; s[121] = ~s[121]; s[122] = ~s[122]; s[123] = ~s[123]; s[124] = ~s[124]; s[125] = ~s[125]; s[127] = ~s[127]; break;
    case 19: s[0] = ~s[0]; s[1] = ~s[1]; s[3] = ~s[3]; s[4] = ~s[4]; s[8] = ~s[8]; s[10] = ~s[10]; s[11] = ~s[11]; s[14] = ~s[14]; s[15] = ~s[15]; s[16] = ~s[16]; s[18] = ~s[18]; s[20] = ~s[20]; s[22] = ~s[22]; s[23] = ~s[23]; s[24] = ~s[24]; s[26] = ~s[26]; s[27] = ~s[27]; s[32] = ~s[32]; s[34] = ~s[34]; s[36] = ~s[36]; s[37] = ~s[37]; s[38] = ~s[38]; s[39] = ~s[39]; s[44] = ~s[44]; s[45] = ~s[45]; s[46] = ~s[46]; s[48] = ~s[48]; s[50] = ~s[50]; s[51] = ~s[51]; s[52] = ~s[52]; s[54] = ~s[54]; s[58] = ~s[58]; s[59] = ~s[59]; s[60] = ~s[60]; s[62] = ~s[62]; s[68] = ~s[68]; s[70] = ~s[70]; s[71] = ~s[71]; s[72] = ~s[72]; s[73] = ~s[73]; s[75] = ~s[75]; s[76] = ~s[76]; s[77] = ~s[77]; s[80] = ~s[80]; s[82] = ~s[82]; s[86] = ~s[86]; s[87] = ~s[87]; s[89] = ~s[89]; s[90] = ~s[90]; s[94] = ~s[94]; s[95] = ~s[95]; s[96] = ~s[96]; s[99] = ~s[99]; s[104] = ~s[104]; s[106] = ~s[106]; s[109] = ~s[109]; s[113] = ~s[113]; s[114] = ~s[114]; s[116] = ~s[116]; s[117] = ~s[117]; s[118] = ~s[118]; s[120] = ~s[120]; s[123] = ~s[123]; s[124] = ~s[124]; s[125] = ~s[125]; s[126] = ~s[126]; break;
    case 20: s[0] = ~s[0]; s[1] = ~s[1]; s[2] = ~s[2]; s[3] = ~s[3]; s[4] = ~s[4]; s[5] = ~s[5]; s[8] = ~s[8]; s[10] = ~s[10]; s[12] = ~s[12]; s[13] = ~s[13]; s[14] = ~s[14]; s[15] = ~s[15]; s[16] = ~s[16]; s[17] = ~s[17]; s[21] = ~s[21]; s[22] = ~s[22]; s[26] = ~s[26]; s[27] = ~s[27]; s[33] = ~s[33]; s[35] = ~s[35]; s[38] = ~s[38]; s[39] = ~s[39]; s[40] = ~s[40]; s[42] = ~s[42]; s[47] = ~s[47]; s[49] = ~s[49]; s[50] = ~s[50]; s[51] = ~s[51]; s[52] = ~s[52]; s[53] = ~s[53]; s[60] = ~s[60]; s[62] = ~s[62]; s[65] = ~s[65]; s[67] = ~s[67]; s[68] = ~s[68]; s[73] = ~s[73]; s[74] = ~s[74]; s[75] = ~s[75]; s[76] = ~s[76]; s[77] = ~s[77]; s[79] = ~s[79]; s[80] = ~s[80]; s[81] = ~s[81]; s[83] = ~s[83]; s[84] = ~s[84]; s[85] = ~s[85]; s[86] = ~s[86]; s[87] = ~s[87]; s[89] = ~s[89]; s[90] = ~s[90]; s[92] = ~s[92]; s[95] = ~s[95]; s[96] = ~s[96]; s[97] = ~s[97]; s[100] = ~s[100]; s[104] = ~s[104]; s[105] = ~s[105]; s[107] = ~s[107]; s[108] = ~s[108]; s[111] = ~s[111]; s[112] = ~s[112]; s[114] = ~s[114]; s[115] = ~s[115]; s[119] = ~s[119]; s[120] = ~s[120]; s[121] = ~s[121]; s[122] = ~s[122]; s[123] = ~s[123]; s[125] = ~s[125]; s[126] = ~s[126]; s[127] = ~s[127]; break;
    case 21: s[0] = ~s[0]; s[2] = ~s[2]; s[3] = ~s[3]; s[4] = ~s[4]; s[11] = ~s[11]; s[13] = ~s[13]; s[15] = ~s[15]; s[18] = ~s[18]; s[19] = ~s[19]; s[20] = ~s[20]; s[21] = ~s[21]; s[23] = ~s[23]; s[24] = ~s[24]; s[28] = ~s[28]; s[29] = ~s[29]; s[30] = ~s[30]; s[32] = ~s[32]; s[33] = ~s[33]; s[34] = ~s[34]; s[36] = ~s[36]; s[38] = ~s[38]; s[39] = ~s[39]; s[40] = ~s[40]; s[42] = ~s[42]; s[43] = ~s[43]; s[45] = ~s[45]; s[49] = ~s[49]; s[55] = ~s[55]; s[56] = ~s[56]; s[61] = ~s[61]; s[64] = ~s[64]; s[66] = ~s[66]; s[67] = ~s[67]; s[70] = ~s[70]; s[71] = ~s[71]; s[72] = ~s[72]; s[73] = ~s[73]; s[76] = ~s[76]; s[79] = ~s[79]; s[80] = ~s[80]; s[83] = ~s[83]; s[84] = ~s[84]; s[85] = ~s[85]; s[86] = ~s[86]; s[88] = ~s[88]; s[89] = ~s[89]; s[90] = ~s[90]; s[92] = ~s[92]; s[93] = ~s[93]; s[95] = ~s[95]; s[97] = ~s[97]; s[98] = ~s[98]; s[99] = ~s[99]; s[100] = ~s[100]; s[102] = ~s[102]; s[103] = ~s[103]; s[107] = ~s[107]; s[114] = ~s[114]; s[116] = ~s[116]; s[117] = ~s[117]; s[118] = ~s[118]; s[119] = ~s[119]; s[123] = ~s[123]; s[124] = ~s[124]; s[126] = ~s[126]; break;
    case 22: s[1] = ~s[1]; s[7] = ~s[7]; s[9] = ~s[9]; s[10] = ~s[10]; s[11] = ~s[11]; s[12] = ~s[12]; s[14] = ~s[14]; s[19] = ~s[19]; s[20] = ~s[20]; s[21] = ~s[21]; s[26] = ~s[26]; s[32] = ~s[32]; s[34] = ~s[34]; s[36] = ~s[36]; s[39] = ~s[39]; s[40] = ~s[40]; s[44] = ~s[44]; s[50] = ~s[50]; s[52] = ~s[52]; s[59] = ~s[59]; s[60] = ~s[60]; s[61] = ~s[61]; s[65] = ~s[65]; s[66] = ~s[66]; s[68] = ~s[68]; s[69] = ~s[69]; s[72] = ~s[72]; s[73] = ~s[73]; s[74] = ~s[74]; s[75] = ~s[75]; s[76] = ~s[76]; s[77] = ~s[77]; s[79] = ~s[79]; s[82] = ~s[82]; s[87] = ~s[87]; s[88] = ~s[88]; s[96] = ~s[96]; s[99] = ~s[99]; s[100] = ~s[100]; s[105] = ~s[105]; s[106] = ~s[106]; s[107] = ~s[107]; s[108] = ~s[108]; s[109] = ~s[109]; s[110] = ~s[110]; s[111] = ~s[111]; s[113] = ~s[113]; s[114] = ~s[114]; s[116] = ~s[116]; s[117] = ~s[117]; s[118] = ~s[118]; s[122] = ~s[122]; s[123] = ~s[123]; s[124] = ~s[124]; s[125] = ~s[125]; s[127] = ~s[127]; break;
    case 23: s[3] = ~s[3]; s[4] = ~s[4]; s[5] = ~s[5]; s[9] = ~s[9]; s[10] = ~s[10]; s[13] = ~s[13]; s[14] = ~s[14]; s[16] = ~s[16]; s[18] = ~s[18]; s[19] = ~s[19]; s[20] = ~s[20]; s[22] = ~s[22]; s[28] = ~s[28]; s[30] = ~s[30]; s[31] = ~s[31]; s[32] = ~s[32]; s[34] = ~s[34]; s[35] = ~s[35]; s[37] = ~s[37]; s[39] = ~s[39]; s[40] = ~s[40]; s[41] = ~s[41]; s[42] = ~s[42]; s[44] = ~s[44]; s[45] = ~s[45]; s[46] = ~s[46]; s[48] = ~s[48]; s[51] = ~s[51]; s[54] = ~s[54]; s[59] = ~s[59]; s[61] = ~s[61]; s[62] = ~s[62]; s[63] = ~s[63]; s[64] = ~s[64]; s[65] = ~s[65]; s[67] = ~s[67]; s[68] = ~s[68]; s[71] = ~s[71]; s[75] = ~s[75]; s[78] = ~s[78]; s[79] = ~s[79]; s[80] = ~s[80]; s[82] = ~s[82]; s[83] = ~s[83]; s[86] = ~s[86]; s[87] = ~s[87]; s[88] = ~s[88]; s[91] = ~s[91]; s[93] = ~s[93]; s[94] = ~s[94]; s[95] = ~s[95]; s[97] = ~s[97]; s[103] = ~s[103]; s[105] = ~s[105]; s[106] = ~s[106]; s[108] = ~s[108]; s[109] = ~s[109]; s[112] = ~s[112]; s[113] = ~s[113]; s[115] = ~s[115]; s[116] = ~s[116]; s[117] = ~s[117]; s[119] = ~s[119]; s[120] = ~s[120]; s[122] = ~s[122]; s[124] = ~s[124]; s[126] = ~s[126]; break;
    case 24: s[0] = ~s[0]; s[1] = ~s[1]; s[2] = ~s[2]; s[3] = ~s[3]; s[4] = ~s[4]; s[5] = ~s[5]; s[10] = ~s[10]; s[11] = ~s[11]; s[15] = ~s[15]; s[16] = ~s[16]; s[21] = ~s[21]; s[23] = ~s[23]; s[24] = ~s[24]; s[25] = ~s[25]; s[30] = ~s[30]; s[31] = ~s[31]; s[33] = ~s[33]; s[36] = ~s[36]; s[39] = ~s[39]; s[40] = ~s[40]; s[41] = ~s[41]; s[43] = ~s[43]; s[44] = ~s[44]; s[45] = ~s[45]; s[46] = ~s[46]; s[47] = ~s[47]; s[51] = ~s[51]; s[53] = ~s[53]; s[54] = ~s[54]; s[55] = ~s[55]; s[56] = ~s[56]; s[57] = ~s[57]; s[59] = ~s[59]; s[61] = ~s[61]; s[64] = ~s[64]; s[67] = ~s[67]; s[72] = ~s[72]; s[73] = ~s[73]; s[76] = ~s[76]; s[77] = ~s[77]; s[80] = ~s[80]; s[82] = ~s[82]; s[85] = ~s[85]; s[89] = ~s[89]; s[94] = ~s[94]; s[95] = ~s[95]; s[96] = ~s[96]; s[97] = ~s[97]; s[99] = ~s[99]; s[103] = ~s[103]; s[104] = ~s[104]; s[106] = ~s[106]; s[113] = ~s[113]; s[114] = ~s[114]; s[115] = ~s[115]; s[116] = ~s[116]; s[119] = ~s[119]; s[120] = ~s[120]; s[121] = ~s[121]; s[122] = ~s[122]; s[124] = ~s[124]; s[127] = ~s[127]; break;
    case 25: s[4] = ~s[4]; s[6] = ~s[6]; s[8] = ~s[8]; s[9] = ~s[9]; s[10] = ~s[10]; s[15] = ~s[15]; s[16] = ~s[16]; s[19] = ~s[19]; s[21] = ~s[21]; s[25] = ~s[25]; s[26] = ~s[26]; s[27] = ~s[27]; s[28] = ~s[28]; s[29] = ~s[29]; s[30] = ~s[30]; s[31] = ~s[31]; s[33] = ~s[33]; s[38] = ~s[38]; s[39] = ~s[39]; s[42] = ~s[42]; s[43] = ~s[43]; s[44] = ~s[44]; s[45] = ~s[45]; s[46] = ~s[46]; s[48] = ~s[48]; s[54] = ~s[54]; s[55] = ~s[55]; s[56] = ~s[56]; s[58] = ~s[58]; s[60] = ~s[60]; s[62] = ~s[62]; s[63] = ~s[63]; s[64] = ~s[64]; s[65] = ~s[65]; s[67] = ~s[67]; s[70] = ~s[70]; s[71] = ~s[71]; s[72] = ~s[72]; s[73] = ~s[73]; s[74] = ~s[74]; s[75] = ~s[75]; s[78] = ~s[78]; s[82] = ~s[82]; s[85] = ~s[85]; s[86] = ~s[86]; s[87] = ~s[87]; s[88] = ~s[88]; s[89] = ~s[89]; s[90] = ~s[90]; s[92] = ~s[92]; s[102] = ~s[102]; s[105] = ~s[105]; s[107] = ~s[107]; s[110] = ~s[110]; s[113] = ~s[113]; s[115] = ~s[115]; s[116] = ~s[116]; s[117] = ~s[117]; s[118] = ~s[118]; s[127] = ~s[127]; break;
    case 26: s[1] = ~s[1]; s[2] = ~s[2]; s[3] = ~s[3]; s[7] = ~s[7]; s[8] = ~s[8]; s[10] = ~s[10]; s[11] = ~s[11]; s[12] = ~s[12]; s[14] = ~s[14]; s[18] = ~s[18]; s[21] = ~s[21]; s[22] = ~s[22]; s[23] = ~s[23]; s[24] = ~s[24]; s[25] = ~s[25]; s[26] = ~s[26]; s[28] = ~s[28]; s[29] = ~s[29]; s[30] = ~s[30]; s[31] = ~s[31]; s[34] = ~s[34]; s[35] = ~s[35]; s[38] = ~s[38]; s[40] = ~s[40]; s[45] = ~s[45]; s[48] = ~s[48]; s[50] = ~s[50]; s[53] = ~s[53]; s[57] = ~s[57]; s[61] = ~s[61]; s[64] = ~s[64]; s[65] = ~s[65]; s[66] = ~s[66]; s[71] = ~s[71]; s[73] = ~s[73]; s[74] = ~s[74]; s[75] = ~s[75]; s[77] = ~s[77]; s[78] = ~s[78]; s[80] = ~s[80]; s[86] = ~s[86]; s[87] = ~s[87]; s[88] = ~s[88]; s[90] = ~s[90]; s[92] = ~s[92]; s[93] = ~s[93]; s[96] = ~s[96]; s[97] = ~s[97]; s[98] = ~s[98]; s[102] = ~s[102]; s[103] = ~s[103]; s[106] = ~s[106]; s[109] = ~s[109]; s[112] = ~s[112]; s[113] = ~s[113]; s[115] = ~s[115]; s[116] = ~s[116]; s[117] = ~s[117]; s[119] = ~s[119]; s[120] = ~s[120]; s[122] = ~s[122]; s[124] = ~s[124]; s[125] = ~s[125]; s[127] = ~s[127]; break;
    case 27: s[3] = ~s[3]; s[5] = ~s[5]; s[7] = ~s[7]; s[8] = ~s[8]; s[9] = ~s[9]; s[10] = ~s[10]; s[12] = ~s[12]; s[13] = ~s[13]; s[15] = ~s[15]; s[16] = ~s[16]; s[20] = ~s[20]; s[21] = ~s[21]; s[24] = ~s[24]; s[28] = ~s[28]; s[29] = ~s[29]; s[34] = ~s[34]; s[37] = ~s[37]; s[38] = ~s[38]; s[39] = ~s[39]; s[41] = ~s[41]; s[42] = ~s[42]; s[44] = ~s[44]; s[47] = ~s[47]; s[50] = ~s[50]; s[52] = ~s[52]; s[56] = ~s[56]; s[57] = ~s[57]; s[60] = ~s[60]; s[64] = ~s[64]; s[65] = ~s[65]; s[69] = ~s[69]; s[70] = ~s[70]; s[75] = ~s[75]; s[76] = ~s[76]; s[77] = ~s[77]; s[78] = ~s[78]; s[79] = ~s[79]; s[80] = ~s[80]; s[82] = ~s[82]; s[84] = ~s[84]; s[86] = ~s[86]; s[87] = ~s[87]; s[89] = ~s[89]; s[90] = ~s[90]; s[93] = ~s[93]; s[98] = ~s[98]; s[101] = ~s[101]; s[103] = ~s[103]; s[106] = ~s[106]; s[107] = ~s[107]; s[108] = ~s[108]; s[110] = ~s[110]; s[111] = ~s[111]; s[113] = ~s[113]; s[114] = ~s[114]; s[115] = ~s[115]; s[117] = ~s[117]; s[118] = ~s[118]; s[120] = ~s[120]; s[121] = ~s[121]; s[124] = ~s[124]; s[127] = ~s[127]; break;
    case 28: s[1] = ~s[1]; s[2] = ~s[2]; s[3] = ~s[3]; s[11] = ~s[11]; s[13] = ~s[13]; s[16] = ~s[16]; s[18] = ~s[18]; s[19] = ~s[19]; s[21] = ~s[21]; s[22] = ~s[22]; s[23] = ~s[23]; s[27] = ~s[27]; s[28] = ~s[28]; s[29] = ~s[29]; s[30] = ~s[30]; s[33] = ~s[33]; s[35] = ~s[35]; s[37] = ~s[37]; s[38] = ~s[38]; s[39] = ~s[39]; s[41] = ~s[41]; s[42] = ~s[42]; s[43] = ~s[43]; s[44] = ~s[44]; s[45] = ~s[45]; s[47] = ~s[47]; s[48] = ~s[48]; s[51] = ~s[51]; s[52] = ~s[52]; s[53] = ~s[53]; s[54] = ~s[54]; s[55] = ~s[55]; s[56] = ~s[56]; s[57] = ~s[57]; s[59] = ~s[59]; s[61] = ~s[61]; s[62] = ~s[62]; s[64] = ~s[64]; s[67] = ~s[67]; s[71] = ~s[71]; s[73] = ~s[73]; s[74] = ~s[74]; s[78] = ~s[78]; s[82] = ~s[82]; s[83] = ~s[83]; s[85] = ~s[85]; s[88] = ~s[88]; s[90] = ~s[90]; s[91] = ~s[91]; s[94] = ~s[94]; s[96] = ~s[96]; s[98] = ~s[98]; s[99] = ~s[99]; s[101] = ~s[101]; s[105] = ~s[105]; s[107] = ~s[107]; s[108] = ~s[108]; s[111] = ~s[111]; s[113] = ~s[113]; s[118] = ~s[118]; s[121] = ~s[121]; s[122] = ~s[122]; s[123] = ~s[123]; s[124] = ~s[124]; s[126] = ~s[126]; s[127] = ~s[127]; break;
    case 29: s[1] = ~s[1]; s[2] = ~s[2]; s[4] = ~s[4]; s[5] = ~s[5]; s[6] = ~s[6]; s[7] = ~s[7]; s[10] = ~s[10]; s[20] = ~s[20]; s[21] = ~s[21]; s[22] = ~s[22]; s[23] = ~s[23]; s[29] = ~s[29]; s[31] = ~s[31]; s[34] = ~s[34]; s[35] = ~s[35]; s[36] = ~s[36]; s[41] = ~s[41]; s[43] = ~s[43]; s[44] = ~s[44]; s[45] = ~s[45]; s[47] = ~s[47]; s[48] = ~s[48]; s[51] = ~s[51]; s[56] = ~s[56]; s[57] = ~s[57]; s[59] = ~s[59]; s[62] = ~s[62]; s[63] = ~s[63]; s[64] = ~s[64]; s[66] = ~s[66]; s[68] = ~s[68]; s[71] = ~s[71]; s[74] = ~s[74]; s[75] = ~s[75]; s[76] = ~s[76]; s[77] = ~s[77]; s[78] = ~s[78]; s[79] = ~s[79]; s[80] = ~s[80]; s[82] = ~s[82]; s[85] = ~s[85]; s[89] = ~s[89]; s[90] = ~s[90]; s[95] = ~s[95]; s[99] = ~s[99]; s[100] = ~s[100]; s[101] = ~s[101]; s[103] = ~s[103]; s[105] = ~s[105]; s[106] = ~s[106]; s[109] = ~s[109]; s[110] = ~s[110]; s[112] = ~s[112]; s[113] = ~s[113]; s[114] = ~s[114]; s[117] = ~s[117]; s[118] = ~s[118]; s[123] = ~s[123]; s[124] = ~s[124]; s[126] = ~s[126]; break;
    case 30: s[0] = ~s[0]; s[2] = ~s[2]; s[6] = ~s[6]; s[8] = ~s[8]; s[15] = ~s[15]; s[17] = ~s[17]; s[19] = ~s[19]; s[20] = ~s[20]; s[23] = ~s[23]; s[26] = ~s[26]; s[27] = ~s[27]; s[30] = ~s[30]; s[31] = ~s[31]; s[32] = ~s[32]; s[35] = ~s[35]; s[36] = ~s[36]; s[38] = ~s[38]; s[40] = ~s[40]; s[41] = ~s[41]; s[43] = ~s[43]; s[44] = ~s[44]; s[45] = ~s[45]; s[48] = ~s[48]; s[49] = ~s[49]; s[52] = ~s[52]; s[55] = ~s[55]; s[56] = ~s[56]; s[57] = ~s[57]; s[58] = ~s[58]; s[66] = ~s[66]; s[67] = ~s[67]; s[70] = ~s[70]; s[71] = ~s[71]; s[72] = ~s[72]; s[73] = ~s[73]; s[74] = ~s[74]; s[78] = ~s[78]; s[79] = ~s[79]; s[81] = ~s[81]; s[82] = ~s[82]; s[84] = ~s[84]; s[85] = ~s[85]; s[87] = ~s[87]; s[88] = ~s[88]; s[95] = ~s[95]; s[98] = ~s[98]; s[100] = ~s[100]; s[101] = ~s[101]; s[102] = ~s[102]; s[104] = ~s[104]; s[109] = ~s[109]; s[111] = ~s[111]; s[112] = ~s[112]; s[116] = ~s[116]; s[118] = ~s[118]; s[119] = ~s[119]; s[120] = ~s[120]; s[123] = ~s[123]; s[124] = ~s[124]; s[126] = ~s[126]; s[127] = ~s[127]; break;
    case 31: s[2] = ~s[2]; s[3] = ~s[3]; s[5] = ~s[5]; s[6] = ~s[6]; s[8] = ~s[8]; s[9] = ~s[9]; s[10] = ~s[10]; s[11] = ~s[11]; s[12] = ~s[12]; s[13] = ~s[13]; s[15] = ~s[15]; s[16] = ~s[16]; s[17] = ~s[17]; s[18] = ~s[18]; s[19] = ~s[19]; s[21] = ~s[21]; s[23] = ~s[23]; s[25] = ~s[25]; s[26] = ~s[26]; s[27] = ~s[27]; s[28] = ~s[28]; s[30] = ~s[30]; s[32] = ~s[32]; s[34] = ~s[34]; s[36] = ~s[36]; s[37] = ~s[37]; s[42] = ~s[42]; s[47] = ~s[47]; s[50] = ~s[50]; s[51] = ~s[51]; s[52] = ~s[52]; s[53] = ~s[53]; s[56] = ~s[56]; s[59] = ~s[59]; s[60] = ~s[60]; s[62] = ~s[62]; s[64] = ~s[64]; s[67] = ~s[67]; s[68] = ~s[68]; s[69] = ~s[69]; s[70] = ~s[70]; s[71] = ~s[71]; s[72] = ~s[72]; s[73] = ~s[73]; s[78] = ~s[78]; s[81] = ~s[81]; s[83] = ~s[83]; s[87] = ~s[87]; s[91] = ~s[91]; s[92] = ~s[92]; s[94] = ~s[94]; s[95] = ~s[95]; s[96] = ~s[96]; s[98] = ~s[98]; s[99] = ~s[99]; s[103] = ~s[103]; s[105] = ~s[105]; s[109] = ~s[109]; s[110] = ~s[110]; s[111] = ~s[111]; s[112] = ~s[112]; s[113] = ~s[113]; s[115] = ~s[115]; s[116] = ~s[116]; s[118] = ~s[118]; s[120] = ~s[120]; break;
    case 32: s[1] = ~s[1]; s[6] = ~s[6]; s[7] = ~s[7]; s[9] = ~s[9]; s[10] = ~s[10]; s[15] = ~s[15]; s[16] = ~s[16]; s[17] = ~s[17]; s[20] = ~s[20]; s[22] = ~s[22]; s[23] = ~s[23]; s[24] = ~s[24]; s[25] = ~s[25]; s[32] = ~s[32]; s[33] = ~s[33]; s[34] = ~s[34]; s[36] = ~s[36]; s[37] = ~s[37]; s[38] = ~s[38]; s[39] = ~s[39]; s[41] = ~s[41]; s[48] = ~s[48]; s[49] = ~s[49]; s[50] = ~s[50]; s[51] = ~s[51]; s[53] = ~s[53]; s[54] = ~s[54]; s[55] = ~s[55]; s[57] = ~s[57]; s[59] = ~s[59]; s[60] = ~s[60]; s[62] = ~s[62]; s[65] = ~s[65]; s[66] = ~s[66]; s[67] = ~s[67]; s[72] = ~s[72]; s[78] = ~s[78]; s[80] = ~s[80]; s[82] = ~s[82]; s[85] = ~s[85]; s[86] = ~s[86]; s[89] = ~s[89]; s[95] = ~s[95]; s[96] = ~s[96]; s[97] = ~s[97]; s[103] = ~s[103]; s[104] = ~s[104]; s[105] = ~s[105]; s[109] = ~s[109]; s[111] = ~s[111]; s[113] = ~s[113]; s[114] = ~s[114]; s[115] = ~s[115]; s[116] = ~s[116]; s[117] = ~s[117]; s[120] = ~s[120]; s[121] = ~s[121]; s[127] = ~s[127]; break;
    default: break;
  }
}

// AddRoundKey with a per-lane key: sel bit 0 takes kKeyLeft's bit,
// sel bit 1 kKeyRight's (no branch on sel).
__device__ __forceinline__ void add_round_key_select(uint32_t (&s)[128], uint32_t sel, int rnd) {
  const uint32_t nsel = ~sel;
  switch (rnd) {
    case 0: s[1] = ~s[1]; s[2] ^= sel; s[5] ^= sel; s[6] = ~s[6]; s[7] ^= nsel; s[8] ^= nsel; s[9] = ~s[9]; s[10] ^= sel; s[11] ^= nsel; s[12] ^= nsel; s[13] = ~s[13]; s[15] ^= sel; s[16] ^= sel; s[18] ^= nsel; s[19] ^= sel; s[20] ^= sel; s[21] ^= nsel; s[22] ^= nsel; s[23] ^= nsel; s[25] ^= sel; s[27] = ~s[27]; s[28] ^= nsel; s[29] ^= nsel; s[30] = ~s[30]; s[32] ^= sel; s[33] = ~s[33]; s[35] = ~s[35]; s[36] ^= nsel; s[37] = ~s[37]; s[38] ^= nsel; s[39] = ~s[39]; s[41] ^= sel; s[43] ^= nsel; s[44] = ~s[44]; s[45] ^= nsel; s[46] ^= sel; s[47] ^= nsel; s[48] = ~s[48]; s[49] = ~s[49]; s[52] = ~s[52]; s[53] = ~s[53]; s[54] = ~s[54]; s[55] = ~s[55]; s[56] = ~s[56]; s[57] = ~s[57]; s[58] ^= nsel; s[59] ^= nsel; s[61] = ~s[61]; s[62] ^= nsel; s[65] ^= nsel; s[66] = ~s[66]; s[67] ^= nsel; s[68] ^= nsel; s[69] = ~s[69]; s[70] = ~s[70]; s[71] = ~s[71]; s[74] ^= nsel; s[75] ^= sel; s[76] = ~s[76]; s[77] = ~s[77]; s[78] ^= nsel; s[79] = ~s[79]; s[80] ^= nsel; s[82] ^= sel; s[83] = ~s[83]; s[84] ^= nsel; s[85] ^= nsel; s[86] ^= nsel; s[87] = ~s[87]; s[91] = ~s[91]; s[92] ^= sel; s[93] = ~s[93]; s[94] = ~s[94]; s[95] ^= sel; s[96] ^= nsel; s[98] ^= sel; s[99] ^= sel; s[100] ^= nsel; s[101] = ~s[101]; s[103] ^= nsel; s[106] ^= sel; s[107] = ~s[107]; s[108] ^= nsel; s[109] = ~s[109]; s[112] ^= nsel; s[114] ^= nsel; s[115] = ~s[115]; s[116] ^= nsel; s[119] ^= nsel; s[120] = ~s[120]; s[124] ^= nsel; s[125] ^= nsel; break;
    case 1: s[1] ^= sel; s[2] = ~s[2]; s[4] ^= sel; s[6] ^= nsel; s[7] ^= nsel; s[8] ^= nsel; s[9] ^= sel; s[10] = ~s[10]; s[12] ^= sel; s[13] ^= nsel; s[14] ^= nsel; s[15] ^= sel; s[16] = ~s[16]; s[17] ^= nsel; s[18] ^= sel; s[21] = ~s[21]; s[22] ^= sel; s[24] ^= sel; s[25] ^= sel; s[27] ^= sel; s[28] = ~s[28]; s[29] = ~s[29]; s[31] ^= nsel; s[32] ^= sel; s[33] ^= nsel; s[34] = ~s[34]; s[35] = ~s[35]; s[36] = ~s[36]; s[37] = ~s[37]; s[39] ^= sel; s[40] ^= nsel; s[42] = ~s[42]; s[43] ^= nsel; s[44] ^= nsel; s[46] = ~s[46]; s[47] = ~s[47]; s[49] ^= sel; s[50] ^= sel; s[52] = ~s[52]; s[54] ^= nsel; s[55] = ~s[55]; s[56] ^= nsel; s[57] ^= nsel; s[58] ^= nsel; s[59] = ~s[59]; s[60] = ~s[60]; s[62] ^= nsel; s[63] ^= nsel; s[64] ^= sel; s[67] ^= sel; s[68] ^= sel; s[70] = ~s[70]; s[71] ^= nsel; s[72] ^= nsel; s[74] ^= sel; s[75] = ~s[75]; s[76] ^= sel; s[77] = ~s[77]; s[78] ^= sel; s[80] ^= nsel; s[81] ^= sel; s[83] = ~s[83]; s[84] ^= sel; s[85] ^= nsel; s[88] ^= nsel; s[89] ^= nsel; s[90] ^= nsel; s[92] ^= nsel; s[93] = ~s[93]; s[94] ^= sel; s[95] = ~s[95]; s[96] = ~s[96]; s[98] ^= sel; s[100] = ~s[100]; s[101] = ~s[101]; s[102] = ~s[102]; s[104] ^= nsel; s[108] = ~s[108]; s[110] ^= sel; s[113] ^= sel; s[114] ^= nsel; s[116] = ~s[116]; s[117] ^= nsel; s[119] ^= nsel; s[120] ^= sel; s[121] ^= nsel; s[122] ^= nsel; s[125] ^= sel; s[126] ^= sel; s[127] = ~s[127]; break;
    case 2: s[0] ^= sel; s[1] ^= sel; s[2] = ~s[2]; s[6] = ~s[6]; s[8] ^= sel; s[9] ^= sel; s[10] ^= sel; s[11] = ~s[11]; s[12] ^= sel; s[13] ^= nsel; s[14] = ~s[14]; s[15] ^= nsel; s[16] = ~s[16]; s[17] ^= nsel; s[18] = ~s[18]; s[19] ^= sel; s[20] ^= sel; s[21] ^= nsel; s[22] ^= nsel; s[23] ^= sel; s[24] ^= nsel; s[25] = ~s[25]; s[26] ^= sel; s[28] ^= nsel; s[29] ^= sel; s[31] ^= sel; s[33] = ~s[33]; s[35] = ~s[35]; s[36] = ~s[36]; s[37] = ~s[37]; s[38] = ~s[38]; s[39] ^= sel; s[40] = ~s[40]; s[41] ^= sel; s[42] ^= nsel; s[43] ^= sel; s[44] = ~s[44]; s[45] ^= nsel; s[47] ^= sel; s[48] = ~s[48]; s[49] = ~s[49]; s[50] ^= nsel; s[51] ^= sel; s[52] ^= nsel; s[53] ^= nsel; s[55] ^= nsel; s[57] ^= sel; s[58] = ~s[58]; s[59] = ~s[59]; s[60] ^= sel; s[61] ^= sel; s[62] ^= nsel; s[63] = ~s[63]; s[64] ^= sel; s[65] = ~s[65]; s[67] ^= nsel; s[68] ^= nsel; s[69] = ~s[69]; s[71] = ~s[71]; s[72] ^= sel; s[73] ^= sel; s[74] = ~s[74]; s[75] ^= nsel; s[76] ^= nsel; s[77] ^= sel; s[78] ^= sel; s[79] ^= sel; s[80] ^= sel; s[81] ^= nsel; s[82] ^= nsel; s[83] ^= nsel; s[84] = ~s[84]; s[87] ^= nsel; s[88] ^= nsel; s[89] = ~s[89]; s[90] ^= sel; s[91] = ~s[91]; s[92] = ~s[92]; s[93] ^= nsel; s[94] = ~s[94]; s[96] ^= nsel; s[97] = ~s[97]; s[98] ^= sel; s[99] ^= nsel; s[100] ^= sel; s[102] = ~s[102]; s[103] = ~s[103]; s[104] = ~s[104]; s[105] ^= sel; s[106] = ~s[106]; s[107] ^= nsel; s[108] ^= sel; s[109] ^= sel; s[111] ^= sel; s[112] ^= sel; s[113] = ~s[113]; s[115] ^= nsel; s[117] ^= nsel; s[120] = ~s[120]; s[121] ^= sel; s[122] = ~s[122]; s[123] = ~s[123]; s[124] = ~s[124]; s[125] = ~s[125]; s[126] ^= nsel; s[127] = ~s[127]; break;
    case 3: s[0] ^= nsel; s[1] = ~s[1]; s[2] ^= nsel; s[3] ^= sel; s[4] ^= nsel; s[5] ^= sel; s[6] ^= sel; s[7] = ~s[7]; s[8] ^= nsel; s[10] = ~s[10]; s[11] ^= nsel; s[13] ^= sel; s[16] = ~s[16]; s[17] ^= nsel; s[18] ^= sel; s[20] = ~s[20]; s[21] ^= nsel; s[23] ^= sel; s[26] ^= nsel; s[27] ^= nsel; s[28] ^= sel; s[30] ^= sel; s[32] ^= nsel; s[34] ^= nsel; s[35] ^= nsel; s[36] ^= sel; s[37] ^= nsel; s[38] ^= nsel; s[39] ^= nsel; s[40] ^= sel; s[41] ^= sel; s[42] ^= sel; s[43] = ~s[43]; s[44] = ~s[44]; s[45] = ~s[45]; s[47] ^= sel; s[49] ^= sel; s[50] = ~s[50]; s[51] ^= sel; s[52] ^= sel; s[55] = ~s[55]; s[57] ^= sel; s[58] ^= sel; s[59] ^= sel; s[61] ^= sel; s[62] = ~s[62]; s[63] = ~s[63]; s[64] = ~s[64]; s[65] = ~s[65]; s[66] ^= nsel; s[68] = ~s[68]; s[69] ^= sel; s[70] ^= nsel; s[71] ^= sel; s[74] ^= nsel; s[75] ^= sel; s[76] ^= sel; s[77] ^= nsel; s[78] ^= sel; s[80] ^= sel; s[81] = ~s[81]; s[82] ^= sel; s[83] = ~s[83]; s[84] ^= nsel; s[87] ^= sel; s[88] ^= nsel; s[89] ^= nsel; s[91] ^= nsel; s[92] = ~s[92]; s[93] = ~s[93]; s[95] = ~s[95]; s[96] ^= sel; s[98] = ~s[98]; s[99] ^= nsel; s[100] ^= nsel; s[101] ^= sel; s[102] ^= sel; s[103] ^= nsel; s[104] = ~s[104]; s[105] ^= sel; s[106] ^= sel; s[107] = ~s[107]; s[109] = ~s[109]; s[110] ^= sel; s[111] ^= sel; s[114] ^= sel; s[115] ^= sel; s[116] ^= nsel; s[117] ^= nsel; s[119] ^= sel; s[120] ^= sel; s[121] = ~s[121]; s[122] = ~s[122]; s[123] ^= sel; s[126] ^= nsel; break;
    case 4: s[0] ^= sel; s[1] ^= nsel; s[2] ^= sel; s[3] = ~s[3]; s[4] = ~s[4]; s[5] = ~s[5]; s[8] ^= nsel; s[11] ^= nsel; s[14] ^= sel; s[16] = ~s[16]; s[17] ^= sel; s[19] ^= nsel; s[21] = ~s[21]; s[22] = ~s[22]; s[23] ^= sel; s[24] ^= sel; s[25] ^= nsel; s[26] ^= sel; s[27] ^= sel; s[28] = ~s[28]; s[30] ^= nsel; s[31] ^= nsel; s[32] = ~s[32]; s[33] ^= nsel; s[34] = ~s[34]; s[35] ^= sel; s[36] ^= nsel; s[37] ^= sel; s[38] ^= nsel; s[39] ^= nsel; s[40] = ~s[40]; s[41] ^= sel; s[42] ^= sel; s[43] ^= sel; s[44] = ~s[44]; s[45] = ~s[45]; s[46] ^= sel; s[47] ^= sel; s[48] = ~s[48]; s[50] = ~s[50]; s[51] = ~s[51]; s[52] ^= sel; s[53] = ~s[53]; s[54] = ~s[54]; s[55] ^= nsel; s[56] ^= sel; s[57] = ~s[57]; s[60] = ~s[60]; s[61] ^= sel; s[62] ^= sel; s[63] ^= sel; s[65] ^= sel; s[66] ^= sel; s[67] ^= sel; s[68] ^= sel; s[71] = ~s[71]; s[72] = ~s[72]; s[73] ^= sel; s[74] = ~s[74]; s[76] ^= nsel; s[77] ^= sel; s[79] ^= sel; s[80] ^= nsel; s[81] = ~s[81]; s[82] ^= nsel; s[84] = ~s[84]; s[85] = ~s[85]; s[86] = ~s[86]; s[87] = ~s[87]; s[88] = ~s[88]; s[89] ^= sel; s[91] ^= nsel; s[93] ^= nsel; s[94] ^= sel; s[95] ^= nsel; s[96] ^= sel; s[97] ^= sel; s[98] ^= nsel; s[99] = ~s[99]; s[100] = ~s[100]; s[101] ^= sel; s[102] ^= sel; s[103] ^= sel; s[106] ^= nsel; s[107] = ~s[107]; s[108] ^= nsel; s[109] ^= nsel; s[110] ^= sel; s[112] ^= nsel; s[113] = ~s[113]; s[114] = ~s[114]; s[115] ^= sel; s[116] ^= sel; s[117] ^= sel; s[118] = ~s[118]; s[119] ^= nsel; s[120] ^= nsel; s[121] ^= nsel; s[122] = ~s[122]; s[123] = ~s[123]; s[125] ^= nsel; s[126] = ~s[126]; s[127] ^= nsel; break;
    case 5: s[0] = ~s[0]; s[1] ^= sel; s[2] ^= sel; s[3] ^= sel; s[4] ^= sel; s[5] ^= sel; s[6] = ~s[6]; s[7] ^= nsel; s[8] = ~s[8]; s[9] = ~s[9]; s[10] ^= nsel; s[11] ^= nsel; s[12] ^= sel; s[13] ^= sel; s[14] ^= nsel; s[15] = ~s[15]; s[17] = ~s[17]; s[18] ^= nsel; s[19] ^= sel; s[20] ^= nsel; s[21] ^= nsel; s[22] ^= sel; s[23] = ~s[23]; s[25] = ~s[25]; s[26] ^= nsel; s[27] ^= nsel; s[28] ^= sel; s[30] ^= nsel; s[33] = ~s[33]; s[34] ^= nsel; s[36] = ~s[36]; s[38] ^= sel; s[41] ^= nsel; s[42] = ~s[42]; s[43] = ~s[43]; s[44] ^= nsel; s[45] ^= nsel; s[46] = ~s[46]; s[47] ^= nsel; s[48] = ~s[48]; s[49] = ~s[49]; s[50] ^= sel; s[51] ^= nsel; s[52] = ~s[52]; s[53] ^= sel; s[54] ^= nsel; s[55] ^= sel; s[56] ^= sel; s[58] ^= nsel; s[59] ^= nsel; s[60] ^= nsel; s[61] ^= sel; s[62] = ~s[62]; s[63] ^= sel; s[65] ^= nsel; s[66] = ~s[66]; s[67] ^= sel; s[68] ^= nsel; s[70] ^= sel; s[71] = ~s[71]; s[72] = ~s[72]; s[73] = ~s[73]; s[75] = ~s[75]; s[77] = ~s[77]; s[78] = ~s[78]; s[79] = ~s[79]; s[80] ^= sel; s[82] = ~s[82]; s[83] ^= nsel; s[85] ^= nsel; s[86] ^= sel; s[87] ^= nsel; s[88] ^= nsel; s[89] ^= sel; s[90] ^= nsel; s[92] ^= nsel; s[93] = ~s[93]; s[94] ^= nsel; s[95] = ~s[95]; s[96] ^= sel; s[97] = ~s[97]; s[98] ^= sel; s[99] ^= nsel; s[100] ^= sel; s[101] ^= sel; s[103] ^= nsel; s[104] = ~s[104]; s[105] = ~s[105]; s[106] ^= nsel; s[108] ^= nsel; s[109] ^= sel; s[110] ^= nsel; s[111] = ~s[111]; s[112] = ~s[112]; s[113] = ~s[113]; s[115] = ~s[115]; s[116] ^= sel; s[117] = ~s[117]; s[118] ^= nsel; s[121] = ~s[121]; s[122] ^= sel; s[123] = ~s[123]; s[124] ^= nsel; s[125] ^= sel; s[126] ^= sel; s[127] ^= sel; break;
    case 6: s[0] = ~s[0]; s[1] ^= nsel; s[2] = ~s[2]; s[3] ^= nsel; s[4] ^= sel; s[5] ^= nsel; s[6] = ~s[6]; s[7] ^= nsel; s[8] ^= sel; s[12] = ~s[12]; s[13] ^= nsel; s[14] ^= sel; s[15] ^= nsel; s[17] ^= sel; s[18] ^= nsel; s[20] ^= nsel; s[21] ^= sel; s[22] ^= sel; s[23] ^= sel; s[27] ^= sel; s[28] ^= nsel; s[29] ^= nsel; s[31] ^= sel; s[32] = ~s[32]; s[33] ^= sel; s[34] ^= sel; s[35] ^= nsel; s[36] ^= nsel; s[37] ^= nsel; s[38] ^= nsel; s[39] ^= nsel; s[40] ^= sel; s[41] ^= nsel; s[42] = ~s[42]; s[43] = ~s[43]; s[44] ^= sel; s[46] ^= nsel; s[48] = ~s[48]; s[49] ^= nsel; s[50] = ~s[50]; s[51] ^= nsel; s[52] ^= sel; s[54] = ~s[54]; s[56] ^= sel; s[58] ^= nsel; s[59] = ~s[59]; s[61] = ~s[61]; s[62] = ~s[62]; s[64] = ~s[64]; s[65] = ~s[65]; s[66] ^= nsel; s[67] = ~s[67]; s[69] ^= nsel; s[70] = ~s[70]; s[71] ^= sel; s[72] ^= nsel; s[73] ^= sel; s[74] = ~s[74]; s[76] ^= sel; s[77] = ~s[77]; s[78] ^= sel; s[79] = ~s[79]; s[80] ^= nsel; s[81] ^= nsel; s[84] ^= sel; s[85] ^= nsel; s[86] ^= nsel; s[87] ^= nsel; s[88] = ~s[88]; s[89] ^= sel; s[91] = ~s[91]; s[92] ^= nsel; s[94] ^= sel; s[95] = ~s[95]; s[96] ^= nsel; s[98] = ~s[98]; s[99] ^= sel; s[100] ^= sel; s[101] = ~s[101]; s[102] = ~s[102]; s[103] = ~s[103]; s[104] ^= sel; s[105] ^= nsel; s[106] ^= sel; s[108] = ~s[108]; s[109] ^= nsel; s[110] = ~s[110]; s[112] ^= sel; s[113] ^= sel; s[115] = ~s[115]; s[117] ^= sel; s[119] ^= nsel; s[120] = ~s[120]; s[121] ^= nsel; s[122] ^= sel; s[125] ^= sel; s[127] ^= nsel; break;
    case 7: s[0] = ~s[0]; s[1] ^= nsel; s[2] ^= nsel; s[3] = ~s[3]; s[5] = ~s[5]; s[6] = ~s[6]; s[7] = ~s[7]; s[10] ^= nsel; s[12] ^= nsel; s[13] = ~s[13]; s[14] ^= nsel; s[15] ^= sel; s[16] ^= sel; s[18] ^= sel; s[19] = ~s[19]; s[20] = ~s[20]; s[21] ^= nsel; s[22] = ~s[22]; s[23] = ~s[23]; s[24] ^= nsel; s[27] = ~s[27]; s[28] ^= sel; s[29] = ~s[29]; s[30] ^= nsel; s[31] ^= nsel; s[33] = ~s[33]; s[34] = ~s[34]; s[35] ^= sel; s[36] ^= nsel; s[37] ^= sel; s[38] ^= sel; s[39] ^= sel; s[40] ^= sel; s[41] ^= nsel; s[42] ^= sel; s[43] = ~s[43]; s[44] = ~s[44]; s[45] = ~s[45]; s[47] ^= sel; s[48] ^= nsel; s[49] ^= nsel; s[50] ^= nsel; s[51] ^= sel; s[52] ^= nsel; s[53] ^= nsel; s[55] = ~s[55]; s[56] = ~s[56]; s[58] ^= nsel; s[60] ^= sel; s[62] ^= sel; s[63] ^= nsel; s[64] = ~s[64]; s[66] ^= sel; s[67] ^= nsel; s[68] ^= nsel; s[69] = ~s[69]; s[70] ^= nsel; s[72] = ~s[72]; s[73] = ~s[73]; s[74] ^= nsel; s[75] = ~s[75]; s[76] ^= nsel; s[78] ^= sel; s[79] ^= nsel; s[82] ^= nsel; s[83] ^= sel; s[84] = ~s[84]; s[86] ^= nsel; s[87] ^= sel; s[89] ^= sel; s[90] ^= nsel; s[91] = ~s[91]; s[92] = ~s[92]; s[95] ^= sel; s[96] ^= sel; s[98] ^= nsel; s[99] = ~s[99]; s[100] = ~s[100]; s[102] ^= sel; s[103] = ~s[103]; s[104] ^= nsel; s[105] ^= sel; s[106] = ~s[106]; s[107] = ~s[107]; s[108] ^= sel; s[109] ^= nsel; s[110] ^= nsel; s[111] ^= nsel; s[112] ^= sel; s[113] ^= sel; s[114] ^= nsel; s[115] ^= nsel; s[116] = ~s[116]; s[117] ^= sel; s[118] ^= nsel; s[119] = ~s[119]; s[120] = ~s[120]; s[121] = ~s[121]; s[122] = ~s[122]; s[123] = ~s[123]; s[124] = ~s[124]; s[125] ^= sel; s[127] = ~s[127]; break;
    case 8: s[0] ^= sel; s[1] = ~s[1]; s[3] = ~s[3]; s[4] = ~s[4]; s[5] ^= nsel; s[8] ^= sel; s[9] ^= nsel; s[10] ^= sel; s[11] ^= sel; s[12] ^= nsel; s[13] ^= nsel; s[14] = ~s[14]; s[15] = ~s[15]; s[16] = ~s[16]; s[17] ^= nsel; s[18] ^= sel; s[20] ^= sel; s[21] ^= nsel; s[22] ^= sel; s[23] ^= sel; s[24] = ~s[24]; s[25] ^= nsel; s[26] = ~s[26]; s[27] ^= sel; s[28] ^= nsel; s[29] ^= nsel; s[32] ^= sel; s[34] = ~s[34]; s[35] ^= nsel; s[36] ^= sel; s[37] = ~s[37]; s[38] ^= sel; s[39] ^= sel; s[43] ^= nsel; s[44] ^= sel; s[45] ^= sel; s[46] = ~s[46]; s[47] ^= nsel; s[48] ^= sel; s[50] = ~s[50]; s[51] ^= sel; s[52] = ~s[52]; s[54] ^= sel; s[55] ^= nsel; s[57] ^= nsel; s[58] ^= sel; s[59] ^= sel; s[60] = ~s[60]; s[61] ^= nsel; s[62] ^= sel; s[63] ^= nsel; s[64] ^= nsel; s[66] ^= nsel; s[68] = ~s[68]; s[70] = ~s[70]; s[71] ^= sel; s[72] = ~s[72]; s[73] = ~s[73]; s[74] ^= nsel; s[75] ^= sel; s[76] = ~s[76]; s[77] ^= sel; s[78] ^= nsel; s[80] ^= sel; s[82] ^= sel; s[86] = ~s[86]; s[87] = ~s[87]; s[89] = ~s[89]; s[90] = ~s[90]; s[91] ^= nsel; s[93] ^= nsel; s[94] ^= sel; s[95] = ~s[95]; s[96] = ~s[96]; s[99] = ~s[99]; s[102] ^= nsel; s[103] ^= nsel; s[104] ^= sel; s[105] ^= nsel; s[106] ^= sel; s[107] ^= nsel; s[108] ^= nsel; s[109] = ~s[109]; s[111] ^= nsel; s[113] ^= sel; s[114] = ~s[114]; s[115] ^= nsel; s[116] = ~s[116]; s[117] ^= sel; s[118] ^= sel; s[120] = ~s[120]; s[123] ^= sel; s[124] = ~s[124]; s[125] = ~s[125]; s[126] ^= sel; break;
    case 9: s[0] = ~s[0]; s[1] ^= sel; s[2] = ~s[2]; s[3] ^= sel; s[4] = ~s[4]; s[5] ^= sel; s[6] ^= nsel; s[7] ^= nsel; s[8] ^= sel; s[9] ^= nsel; s[10] = ~s[10]; s[11] ^= nsel; s[12] ^= sel; s[13] = ~s[13]; s[14] = ~s[14]; s[15] ^= sel; s[16] ^= sel; s[17] ^= sel; s[18] ^= nsel; s[21] = ~s[21]; s[22] = ~s[22]; s[23] ^= nsel; s[25] ^= nsel; s[26] ^= sel; s[27] = ~s[27]; s[29] ^= nsel; s[30] ^= nsel; s[31] ^= nsel; s[32] ^= nsel; s[33] ^= sel; s[35] = ~s[35]; s[36] ^= nsel; s[37] ^= nsel; s[38] = ~s[38]; s[39] = ~s[39]; s[40] ^= sel; s[41] ^= nsel; s[42] = ~s[42]; s[45] ^= nsel; s[47] = ~s[47]; s[49] ^= sel; s[50] ^= sel; s[51] ^= sel; s[52] = ~s[52]; s[53] = ~s[53]; s[54] ^= nsel; s[59] ^= nsel; s[60] = ~s[60]; s[62] = ~s[62]; s[65] ^= sel; s[66] ^= nsel; s[67] = ~s[67]; s[68] ^= sel; s[69] ^= nsel; s[71] ^= nsel; s[72] ^= nsel; s[73] ^= sel; s[74] ^= sel; s[75] ^= sel; s[76] = ~s[76]; s[77] = ~s[77]; s[78] ^= nsel; s[79] = ~s[79]; s[80] ^= sel; s[81] ^= sel; s[83] ^= sel; s[84] = ~s[84]; s[85] = ~s[85]; s[86] ^= sel; s[87] = ~s[87]; s[89] = ~s[89]; s[90] = ~s[90]; s[92] = ~s[92]; s[93] ^= nsel; s[94] ^= nsel; s[95] = ~s[95]; s[96] = ~s[96]; s[97] ^= sel; s[98] ^= nsel; s[100] ^= sel; s[101] ^= nsel; s[102] ^= nsel; s[104] = ~s[104]; s[105] = ~s[105]; s[107] = ~s[107]; s[108] ^= sel; s[110] ^= nsel; s[111] ^= sel; s[112] ^= sel; s[114] = ~s[114]; s[115] = ~s[115]; s[117] ^= nsel; s[119] = ~s[119]; s[120] = ~s[120]; s[121] = ~s[121]; s[122] = ~s[122]; s[123] ^= sel; s[125] ^= sel; s[126] = ~s[126]; s[127] = ~s[127]; break;
    case 10: s[0] ^= sel; s[2] ^= sel; s[3] ^= sel; s[4] = ~s[4]; s[6] ^= nsel; s[8] ^= nsel; s[9] ^= nsel; s[10] ^= nsel; s[11] = ~s[11]; s[12] ^= nsel; s[13] = ~s[13]; s[14] ^= nsel; s[15] = ~s[15]; s[17] ^= nsel; s[18] ^= sel; s[19] ^= sel; s[20] ^= sel; s[21] = ~s[21]; s[23] ^= sel; s[24] = ~s[24]; s[25] ^= nsel; s[26] ^= nsel; s[28] ^= sel; s[29] = ~s[29]; s[30] ^= sel; s[31] ^= nsel; s[32] = ~s[32]; s[33] ^= sel; s[34] ^= sel; s[35] ^= nsel; s[36] ^= sel; s[37] ^= nsel; s[38] ^= sel; s[39] = ~s[39]; s[40] = ~s[40]; s[42] ^= sel; s[43] = ~s[43]; s[44] ^= nsel; s[45] ^= sel; s[46] ^= nsel; s[49] = ~s[49]; s[52] ^= nsel; s[54] ^= nsel; s[55] ^= sel; s[56] = ~s[56]; s[57] ^= nsel; s[58] ^= nsel; s[59] ^= nsel; s[60] ^= nsel; s[61] = ~s[61]; s[62] ^= nsel; s[63] ^= nsel; s[64] = ~s[64]; s[66] = ~s[66]; s[67] ^= sel; s[70] ^= sel; s[71] ^= sel; s[72] ^= sel; s[73] ^= sel; s[75] ^= nsel; s[76] ^= sel; s[77] ^= nsel; s[79] = ~s[79]; s[80] ^= sel; s[81] ^= nsel; s[83] ^= sel; s[84] ^= sel; s[85] = ~s[85]; s[86] = ~s[86]; s[87] ^= nsel; s[88] = ~s[88]; s[89] ^= sel; s[90] ^= sel; s[91] ^= nsel; s[92] ^= sel; s[93] ^= sel; s[95] ^= sel; s[97] ^= sel; s[98] ^= sel; s[99] ^= sel; s[100] ^= sel; s[101] ^= nsel; s[102] = ~s[102]; s[103] ^= sel; s[104] ^= nsel; s[105] ^= nsel; s[107] ^= sel; s[109] ^= nsel; s[110] ^= nsel; s[111] ^= nsel; s[113] ^= nsel; s[114] = ~s[114]; s[115] ^= nsel; s[116] ^= sel; s[117] ^= sel; s[118] = ~s[118]; s[119] ^= sel; s[121] ^= nsel; s[122] ^= nsel; s[123] = ~s[123]; s[124] ^= sel; s[126] = ~s[126]; s[127] ^= nsel; break;
    default: break;
  }
}

// ShiftRows: position k = 4c + r of the shifted state takes input byte
// r + 4 * ((c + r) % 4).
__device__ __forceinline__ int shift_rows_source(int k) {
  return (k & 3) + 4 * (((k >> 2) + (k & 3)) & 3);
}

// One MixColumns output byte (8 planes) from its shifted byte a, the
// pair sum v = a ^ a_{r+1} and the pair sum v2 = a_{r+2} ^ a_{r+3}.
__device__ __forceinline__ void mix_byte(const uint32_t (&a)[8], const uint32_t (&v)[8], const uint32_t (&v2)[8], uint32_t (&o)[8]) {
  o[0] = a[0] ^ v[0] ^ v2[0] ^ v[7];
  o[1] = a[1] ^ v[1] ^ v2[1] ^ v[0] ^ v[7];
  o[2] = a[2] ^ v[2] ^ v2[2] ^ v[1];
  o[3] = a[3] ^ v[3] ^ v2[3] ^ v[2] ^ v[7];
  o[4] = a[4] ^ v[4] ^ v2[4] ^ v[3] ^ v[7];
  o[5] = a[5] ^ v[5] ^ v2[5] ^ v[4];
  o[6] = a[6] ^ v[6] ^ v2[6] ^ v[5];
  o[7] = a[7] ^ v[7] ^ v2[7] ^ v[6];
}

// Round-key bytes [key id][round][byte] of kKeyLeft, kKeyRight, kKeyValue.
#ifdef __CUDACC__
#define DPF_KEY_TABLE static __device__ const
#else
#define DPF_KEY_TABLE static const
#endif
DPF_KEY_TABLE uint8_t kRoundKeyBytes[3][11][16] = {
  {
    {194, 59, 228, 120, 250, 184, 243, 111, 254, 244, 249, 104, 177, 56, 157, 49},
    {196, 101, 35, 176, 62, 221, 208, 223, 192, 41, 41, 183, 113, 17, 180, 134},
    {68, 232, 103, 19, 122, 53, 183, 204, 186, 28, 158, 123, 203, 13, 42, 253},
    {151, 13, 51, 12, 237, 56, 132, 192, 87, 36, 26, 187, 156, 41, 48, 70},
    {58, 9, 105, 210, 215, 49, 237, 18, 128, 21, 247, 169, 28, 60, 199, 239},
    {193, 207, 182, 78, 22, 254, 91, 92, 150, 235, 172, 245, 138, 215, 107, 26},
    {239, 176, 20, 48, 249, 78, 79, 108, 111, 165, 227, 153, 229, 114, 136, 131},
    {239, 116, 248, 233, 22, 58, 183, 133, 121, 159, 84, 28, 156, 237, 220, 159},
    {58, 242, 35, 55, 44, 200, 148, 178, 85, 87, 192, 174, 201, 186, 28, 49},
    {213, 110, 228, 234, 249, 166, 112, 88, 172, 241, 176, 246, 101, 75, 172, 199},
    {80, 255, 34, 167, 169, 89, 82, 255, 5, 168, 226, 9, 96, 227, 78, 206},
  },
  {
    {102, 166, 25, 74, 171, 82, 243, 35, 228, 184, 140, 248, 44, 44, 8, 1},
    {22, 150, 101, 59, 189, 196, 150, 24, 89, 124, 26, 224, 117, 80, 18, 225},
    {71, 95, 157, 166, 250, 155, 11, 190, 163, 231, 17, 94, 214, 183, 3, 191},
    {234, 36, 149, 80, 16, 191, 158, 238, 179, 88, 143, 176, 101, 239, 140, 15},
    {61, 64, 227, 29, 45, 255, 125, 243, 158, 167, 242, 67, 251, 72, 126, 76},
    {127, 179, 202, 18, 82, 76, 183, 225, 204, 235, 69, 162, 55, 163, 59, 238},
    {85, 81, 226, 136, 7, 29, 85, 105, 203, 246, 16, 203, 252, 85, 43, 37},
    {233, 160, 221, 56, 238, 189, 136, 81, 37, 75, 152, 154, 217, 30, 179, 191},
    {27, 205, 213, 13, 245, 112, 93, 92, 208, 59, 197, 198, 9, 37, 118, 121},
    {63, 245, 99, 12, 202, 133, 62, 80, 26, 190, 251, 150, 19, 155, 141, 239},
    {29, 168, 188, 113, 215, 45, 130, 33, 205, 147, 121, 183, 222, 8, 244, 88},
  },
  {
    {130, 94, 56, 4, 149, 17, 20, 56, 54, 191, 132, 1, 25, 254, 118, 188},
    {56, 102, 93, 208, 173, 119, 73, 232, 155, 200, 205, 233, 130, 54, 187, 85},
    {63, 140, 161, 195, 146, 251, 232, 43, 9, 51, 37, 194, 139, 5, 158, 151},
    {80, 135, 41, 254, 194, 124, 193, 213, 203, 79, 228, 23, 64, 74, 122, 128},
    {142, 93, 228, 247, 76, 33, 37, 34, 135, 110, 193, 53, 199, 36, 187, 181},
    {168, 183, 49, 49, 228, 150, 20, 19, 99, 248, 213, 38, 164, 220, 110, 147},
    {14, 40, 237, 120, 234, 190, 249, 107, 137, 70, 44, 77, 45, 154, 66, 222},
    {246, 4, 240, 160, 28, 186, 9, 203, 149, 252, 37, 134, 184, 102, 103, 88},
    {69, 129, 154, 204, 89, 59, 147, 7, 204, 199, 182, 129, 116, 161, 209, 217},
    {108, 191, 175, 94, 53, 132, 60, 89, 249, 67, 138, 216, 141, 226, 91, 1},
    {194, 134, 211, 3, 247, 2, 239, 90, 14, 65, 101, 130, 131, 163, 62, 131},
  },
};
